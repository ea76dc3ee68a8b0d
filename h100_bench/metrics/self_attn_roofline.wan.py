"""self_attn_roofline.wan: Wan's self-attention's share of its roofline in
the profiled clip, in %: the bound of every call (``flops_wan.self_attention``
at the clip's video tokens: 4 S^2 D H FLOPs against q, k, v and o in bf16
and the norm weights and RoPE tables in float32; 48 calls a forward, two
forwards a step) over the device time of the across-heads prep with RoPE
and of ``flash_fwd_sm90_kernel`` (``flops_wan.attention_share``)."""

from h100_bench import flops_wan


def read(data):
    return flops_wan.attention_share(data, flops_wan.SELF_KERNELS, flops_wan.self_attention)
