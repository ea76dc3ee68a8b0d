"""textflux_torch: the PyTorch/CUDA port of textflux-tpu (FLUX.1-Fill scene-text
editing), with its attention kernel hand-written for NVIDIA Hopper."""
