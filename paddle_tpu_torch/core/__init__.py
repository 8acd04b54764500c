"""Core runtime pieces of the port (device placement)."""
