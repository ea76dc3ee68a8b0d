"""mfu.serve: the model FLOPs of every image of the window (``flops.edit_image``:
T5, CLIP, the VAE encode, 30 DiT forwards, the decode) over the images'
wall time, over the configuration's peak, in %. The profiled request is
left out."""


def read(data):
    if not data.get("busy_wall_s"):
        return None
    return 100.0 * data["flops"] / data["busy_wall_s"] / data["cfg"]["peak"]["flops_per_s"]
