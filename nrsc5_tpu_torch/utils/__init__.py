"""Host utilities of the port (copies of the reference package's)."""
