"""Sources and the scoring engine."""
