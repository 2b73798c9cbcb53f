"""Per-round feedback learners (linear probes), in PyTorch."""

from .logistic_regression import LogisticRegression, RankRegression  # noqa: F401
