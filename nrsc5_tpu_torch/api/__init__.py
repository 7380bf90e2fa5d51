"""The port's public event types (a copy of the reference package's)."""
