"""denoise_step_ms.serve: the mean of the CUDA-event spans around each call
of ``FillPipeline._denoise_step`` over the window (the DiT's velocity and
the sampler's update), in ms."""


def read(data):
    ms = data["spans"].get("denoise_step")
    return sum(ms) / len(ms) if ms else None
