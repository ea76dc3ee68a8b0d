"""fused_attn_roofline.qwen: the fused attention's share of its roofline in
the profiled request, in %.

The bound of every call (``flops_qwen.fused_attention`` at the joint
length the algorithm needs: the image tokens and the text at its own
length, the prompt's in one forward and the negative's in the other, 60
calls each a step) over the device time of the two kernels that make a
call, ``norm_rope_kernel`` and ``flash_fwd_sm90_kernel``, as the profiler
timed them. The kernels also run the text's padding, which the bound does
not count. Nothing is read when the profile is missing or its calls are
not one of each kernel per block, forward and step."""

from h100_bench import flops, flops_qwen

KERNELS = ("norm_rope_kernel", "flash_fwd_sm90_kernel")


def read(data):
    trace = data.get("trace") or {}
    if not trace.get("kernels") or not trace.get("images"):
        return None
    cfg = data["cfg"]["qwen_dit"]
    layers = cfg["num_layers"]
    bound, calls = 0.0, 0
    for img in trace["images"]:
        per_step = sum(layers * flops.bound_s(*flops_qwen.fused_attention(cfg, img["n_img"] + n),
                                              data["cfg"]["peak"])
                       for n in (img["n_pos"], img["n_neg"]))
        bound += img["steps"] * per_step
        calls += img["steps"] * 2 * layers
    seconds = 0.0
    for kernel in KERNELS:
        hits = [v for name, v in trace["kernels"].items() if kernel in name]
        if sum(c for c, _ in hits) != calls:
            return None
        seconds += sum(s for _, s in hits)
    return 100.0 * bound / seconds if seconds > 0 else None
