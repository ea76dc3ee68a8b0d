"""mfu.qwen: the model FLOPs of every image of the window
(``flops_qwen.edit_image``: the Qwen2.5 encoder over both prompts, the Wan
encode, 30 steps of two DiT forwards, the decode) over the images' wall
time on the host's clock, over the configuration's peak, in %. The
profiled request is left out."""


def read(data):
    if not data.get("busy_wall_s"):
        return None
    return 100.0 * data["flops"] / data["busy_wall_s"] / data["cfg"]["peak"]["flops_per_s"]
