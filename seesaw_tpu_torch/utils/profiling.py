"""Named spans for the PyTorch profiler (counterpart of
`seesaw_tpu/utils/profiling.py::annotate`), and the card line that every
device measurement is written beside."""
from __future__ import annotations

import subprocess

import torch


def annotate(name: str):
    """Named span inside a `torch.profiler` trace (a cheap no-op outside
    one)."""
    return torch.profiler.record_function(name)


def card_line() -> str:
    """The card's name and power limit, as `nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader` prints them for the first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]
