"""PyTorch counterparts of seesaw_tpu.ops on the serving path."""
