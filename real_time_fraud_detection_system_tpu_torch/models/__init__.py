"""The model zoo: scaler, logistic regression, mlp, autoencoder, the
tree-ensemble scorers (forest and gbt) and the sequence transformer, with
their offline trainers, the training pipeline (``train.py``), model
selection, metrics, the sklearn oracle and the plots."""
