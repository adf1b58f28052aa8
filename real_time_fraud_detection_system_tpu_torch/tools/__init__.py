"""The port's command-line tools."""
