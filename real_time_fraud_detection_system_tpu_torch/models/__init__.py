"""Scaler and tree-ensemble scorers."""
