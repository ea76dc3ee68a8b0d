"""fused_attn_roofline.serve: the fused attention's share of its roofline in
the profiled request, in %.

The bound of every call (``flops.fused_attention`` from the joint length:
57 calls a step, the 19 double blocks with per-row norm tables, the 38
single ones with one row each) over the device time of the two kernels
that make a call, ``norm_rope_kernel`` and ``flash_fwd_sm90_kernel``, as
the profiler timed them. Nothing is read when the profile is missing or
its calls are not one of each kernel per block and step."""

from h100_bench import flops

KERNELS = ("norm_rope_kernel", "flash_fwd_sm90_kernel")


def read(data):
    trace = data.get("trace") or {}
    if not trace.get("kernels") or not trace.get("images"):
        return None
    cfg = data["cfg"]["flux"]
    n_double, n_single = cfg["num_layers"], cfg["num_single_layers"]
    bound, calls = 0.0, 0
    for img in trace["images"]:
        seq = img["n_txt"] + img["n_img"]
        per_step = sum(n * flops.bound_s(*flops.fused_attention(cfg, seq, double),
                                         data["cfg"]["peak"])
                       for n, double in ((n_double, True), (n_single, False)))
        bound += img["steps"] * per_step
        calls += img["steps"] * (n_double + n_single)
    seconds = 0.0
    for kernel in KERNELS:
        hits = [v for name, v in trace["kernels"].items() if kernel in name]
        if sum(c for c, _ in hits) != calls:
            return None
        seconds += sum(s for _, s in hits)
    return 100.0 * bound / seconds if seconds > 0 else None
