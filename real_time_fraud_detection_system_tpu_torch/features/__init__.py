"""Feature spec and online feature state."""
