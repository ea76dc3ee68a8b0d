"""denoise_step_ms.qwen: the mean of the CUDA-event spans around each call
of ``QwenImagePipeline._denoise_step`` over the window (the prompt's and
the negative's DiT forward, the guidance, the Euler step and the blend),
in ms."""


def read(data):
    ms = data["spans"].get("denoise_step")
    return sum(ms) / len(ms) if ms else None
