"""Telemetry spine of the port (the energy ledger)."""
