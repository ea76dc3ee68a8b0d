"""cross_attn_roofline.wan: Wan's cross-attention's share of its roofline in
the profiled clip, in %: the bound of every call
(``flops_wan.cross_attention``: the video tokens against the 512 text keys,
4 S L D H FLOPs against q, o, k and v in bf16 and the norm weights; 48 calls
a forward, two forwards a step) over the device time of the across-heads
prep without RoPE and of ``flash_fwd_cross_sm90_kernel``
(``flops_wan.attention_share``)."""

from h100_bench import flops_wan


def read(data):
    return flops_wan.attention_share(data, flops_wan.CROSS_KERNELS, flops_wan.cross_attention)
