"""Host/device batch representation."""
