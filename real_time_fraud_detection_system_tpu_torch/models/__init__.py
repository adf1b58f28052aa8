"""Scaler, logistic regression and the tree-ensemble scorers (forest and
gbt)."""
