"""The benchmark of seesaw_tpu_torch (see README.md)."""
