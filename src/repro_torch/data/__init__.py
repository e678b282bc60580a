"""Synthetic training data of the port."""
