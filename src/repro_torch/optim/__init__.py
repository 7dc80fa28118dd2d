"""Optimizers and learning-rate schedules (the counterpart of
``repro/optim/sgd.py``)."""
