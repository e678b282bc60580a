"""Continuous-batching serving engine of the port (no scheduler yet)."""
