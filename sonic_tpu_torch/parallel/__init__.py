"""Multi-GPU proving over torch.distributed (port of `sonic_tpu/parallel/`)."""
