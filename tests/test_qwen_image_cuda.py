"""Qwen-Image's serving path on the card: the fused attention's key lengths
read from the device, and the DiT's CUDA graphs over texts of many lengths.

Like ``tests/test_torch_cuda.py`` these carry the ``cuda`` marker and skip
without a CUDA device:

    python -m pytest tests/test_qwen_image_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from textflux_torch.config import QwenImageConfig
from textflux_torch.models import transformer as T
from textflux_torch.models.qwen_image import (QwenImageTransformer, model_timesteps, qwen_apply,
                                              qwen_vec, rope_ids, text_bucket)
from textflux_torch.ops import flash_attention as FA
from textflux_torch.ops.rope import rope_tables_half

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def test_key_lengths_from_the_device_match_the_int(cuda):
    """Two samples with their own key lengths in one launch: each row
    bitwise the single-sample launch at that length as an int."""
    g = torch.Generator(device=cuda).manual_seed(0)
    b, s, h, d = 2, 1088, 24, 128
    ids = rope_ids(32, 32, s - 1024)
    cos, sin = (torch.as_tensor(x, device=cuda) for x in rope_tables_half(ids, (16, 56, 56)))
    q, k, v = (torch.randn(b, s, h, d, generator=g, device=cuda).to(torch.bfloat16)
               for _ in range(3))
    qs, ks = (1 + 0.1 * torch.randn(s, d, generator=g, device=cuda) for _ in range(2))
    lens = (1024 + 17, 1024 + 64)
    out = FA.flash_attention_qk_norm_rope(q, k, v, cos, sin, qs, ks,
                                          kv_len=torch.tensor(lens, dtype=torch.int32,
                                                              device=cuda))
    for i, n in enumerate(lens):
        one = FA.flash_attention_qk_norm_rope(q[i:i + 1], k[i:i + 1], v[i:i + 1], cos, sin, qs,
                                              ks, kv_len=n)
        assert torch.equal(out[i:i + 1], one)
        ref = FA.flash_attention_qk_norm_rope_reference(q[i:i + 1], k[i:i + 1], v[i:i + 1], cos,
                                                        sin, qs, ks, kv_len=n)
        assert (out[i:i + 1].float() - ref.float()).abs().max() < 2e-2


def test_texts_of_one_bucket_replay_one_graph(cuda):
    """A two-block DiT at Qwen-Image's widths: texts of 300 to 420 tokens
    (bucket 512) replay the graph the first captured, each bitwise the
    eager forward at its own padding."""
    cfg = QwenImageConfig(num_double_layers=2)
    dit = QwenImageTransformer(cfg, device=cuda, dtype=torch.bfloat16).requires_grad_(False)
    T.half_permute_flux_params(dit)
    g = torch.Generator(device=cuda).manual_seed(1)
    grid = (32, 40)
    x = torch.randn(1, grid[0] * grid[1], 64, generator=g, device=cuda).to(torch.bfloat16)
    with torch.inference_mode():
        mods = T.flux_mods(dit, qwen_vec(dit, model_timesteps([0.7], device=cuda)))

    def call(n, graphed):
        txt = torch.randn(1, n, cfg.joint_dim, generator=torch.Generator(device=cuda)
                          .manual_seed(n), device=cuda).to(torch.bfloat16)
        bucket = text_bucket(n)
        txt = torch.nn.functional.pad(txt, (0, 0, 0, bucket - n))
        cos, sin = (torch.as_tensor(t, device=cuda) for t in rope_tables_half(
            rope_ids(*grid, bucket), cfg.axes_dims_rope))
        kv = torch.full((1,), x.shape[1] + n, dtype=torch.int32, device=cuda)
        with torch.inference_mode():
            if not graphed:
                return dit._forward(x, txt, cos, sin, attn_impl="fused", kv_len=kv, mods=mods)
            return qwen_apply(dit, x, txt, cos, sin, mods=mods, attn_impl="fused", kv_len=kv)

    lengths = (300, 333, 377, 401, 420)
    got = [call(n, True) for n in lengths]
    assert dit.graphs.captures == 1 and dit.graphs.replays == len(lengths) - 2
    for n, y in zip(lengths, got):
        assert torch.equal(y, call(n, False)), n
    assert np.isfinite(got[-1].float().cpu().numpy()).all()
