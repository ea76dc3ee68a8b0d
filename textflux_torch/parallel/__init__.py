"""Multi-device serving over torch.distributed (the port of textflux_tpu/parallel)."""
