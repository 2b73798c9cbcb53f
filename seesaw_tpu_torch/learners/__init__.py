"""Per-round feedback learners (linear probes), in PyTorch."""

from .logistic_regression import LogisticRegression  # noqa: F401
