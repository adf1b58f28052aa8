"""Result sinks."""
