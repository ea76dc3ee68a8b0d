"""Wan2.1-VACE's kernels and serving forward on the card: the across-heads
prep and the mainloop with keys of their own length against their plain
versions at the cell's token counts, the self-attention launches held
bitwise to the recorded kernel (``DIGESTS``), and the DiT's eager,
captured and replayed forwards bitwise equal.

Like ``tests/test_torch_cuda.py`` these carry the ``cuda`` marker and skip
without a CUDA device:

    python -m pytest tests/test_wan_vace_cuda.py -m cuda -q --noconftest
"""

import math
import os
import sys

import numpy as np
import pytest
import torch

from textflux_torch.config import WanVACEConfig
from textflux_torch.models import transformer as T
from textflux_torch.models.wan import (WanVACETransformer, rope_ids, step_mods,
                                       wan_mods, wan_temb)
from textflux_torch.ops import flash_attention as FA

pytestmark = pytest.mark.cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the cell's canvases: 5 latent frames of 38 x 52 and 56 x 30 tokens
GRIDS = {9880: (5, 38, 52), 8400: (5, 56, 30)}
HEADS, HEAD_DIM, TEXT = 40, 128, 512
# tools/attention_digests.py on the forward mainloop of 128-key stages and
# ping-pong consumers (one H100 80GB HBM3); a change of the mainloop's
# rounding order is recorded anew here, the tolerance tests being the contract
DIGESTS = {"fused_flux_1664": "6880b55c811f5d1980068b036072c39f8663b97668a76cac132ac82dee0d3522",
           "fused_qwen_kv_lens": "c438f7d4b7e70af2588656582bbfafd4bfddff507ee62eb8139f8bb5051cb2d2",
           "flash_fwd_4224": "56a5d580472e059d9175af9738a8474e1d5a304c59bf92f5d91c700df2744f1f"}


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _ulps(got, want):
    """|got - want| in bf16 last places at |want|, or at the RMS of its row
    (the last axis) where |want| is smaller: an element near zero, where
    float32 sums in another order cancel differently, is judged at its
    row's scale. A tensor."""
    want = want.float()
    rms = want.square().mean(-1, keepdim=True).sqrt()
    _, e = torch.frexp(torch.maximum(want.abs(), rms).clamp_min(2.0 ** -126))
    return (got.float() - want).abs() / torch.ldexp(torch.ones_like(want), e - 8)


def _inputs(cuda, seq, seq_k, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    d = HEADS * HEAD_DIM
    qkv = torch.randn(1, seq, 3 * d, generator=g, device=cuda).to(torch.bfloat16)
    kv = torch.randn(1, seq_k, 2 * d, generator=g, device=cuda).to(torch.bfloat16)
    w = [(1 + 0.1 * torch.randn(d, generator=g, device=cuda)) for _ in range(2)]

    def heads(t):
        return t.reshape(1, t.shape[1], HEADS, HEAD_DIM)

    q, k, v = (heads(t) for t in qkv.chunk(3, -1))     # strided views, as the block has them
    ck, cv = (heads(t) for t in kv.chunk(2, -1))
    return q, k, v, ck, cv, w


def _tables(cuda, seq):
    cos, sin = T.rope_tables(rope_ids(*GRIDS[seq]), (44, 42, 42), 10000)
    return torch.as_tensor(cos, device=cuda), torch.as_tensor(sin, device=cuda)


def _attend(qn, kn, v):
    """The mainloop's plain version on prepped q' (log2 units) and k': exp2
    softmax, P rounded to bf16, fp32 sums; a few heads at a time."""
    out = []
    for h in range(0, qn.shape[2], 8):
        s = torch.einsum("bqhd,bkhd->bhqk", qn[:, :, h:h + 8].float(), kn[:, :, h:h + 8].float())
        p = torch.exp2(s - s.amax(-1, keepdim=True))
        o = torch.einsum("bhqk,bkhd->bqhd", p.to(torch.bfloat16).float(),
                         v[:, :, h:h + 8].float())
        out.append(o / p.sum(-1).transpose(1, 2)[..., None])
    return torch.cat(out, 2).to(torch.bfloat16)


@pytest.mark.parametrize("seq", sorted(GRIDS))
def test_across_heads_prep_within_one_place(cuda, seq):
    """The prep of the self-attention's q and k (RoPE) and of the
    cross-attention's q and its 512 text keys (no RoPE): within one bf16
    place of the plain version, which rounds once as the kernel does."""
    q, k, _, ck, _, (wq, wk) = _inputs(cuda, seq, TEXT, seq)
    cos, sin = _tables(cuda, seq)
    mul = FA.LOG2_E / math.sqrt(HEAD_DIM)
    for kk, tables in ((k, (cos, sin)), (ck, (None, None))):
        qn, kn = FA.across_heads_prep(q, kk, wq, wk, *tables)
        rq = FA.across_heads_prep_reference(q, wq, *tables, eps=1e-6, mul=mul,
                                            dtype=torch.bfloat16)
        rk = FA.across_heads_prep_reference(kk, wk, *tables, eps=1e-6, mul=1.0,
                                            dtype=torch.bfloat16)
        assert qn.shape == q.shape and kn.shape == kk.shape
        worst = float(_ulps(qn, rq).max()), float(_ulps(kn, rk).max())
        assert max(worst) <= 1.0, worst


@pytest.mark.parametrize("seq", sorted(GRIDS))
def test_self_and_cross_attention_within_one_place(cuda, seq):
    """``attn_self`` (seq_k = seq, flash_fwd_sm90_kernel) and ``attn_cross``
    (seq_k = 512, flash_fwd_cross_sm90_kernel) against the mainloop's plain
    version on the kernels' own prep, and deterministic: within one bf16
    place at 99.5% of the elements and four at any. The kernel rounds P to
    bf16 against each tile's running max and sums in another order; the
    plain version rounds it against the row's max, which moves a few
    elements past one place (3 at most, 0.2% of them, on the card)."""
    q, k, v, ck, cv, (wq, wk) = _inputs(cuda, seq, TEXT, seq + 1)
    cos, sin = _tables(cuda, seq)
    launches = FA.attn_self.launches, FA.attn_cross.launches
    for kk, vv, tables, fn in ((k, v, (cos, sin), lambda: FA.attn_self(q, k, v, wq, wk, cos, sin)),
                               (ck, cv, (None, None), lambda: FA.attn_cross(q, ck, cv, wq, wk))):
        out = fn()
        assert out.shape == q.shape and torch.equal(out, fn())
        ref = _attend(*FA.across_heads_prep(q, kk, wq, wk, *tables), vv)
        ulps = _ulps(out, ref)
        seen = float(ulps.max()), float((ulps > 1.0).float().mean())
        assert seen[0] <= 4.0 and seen[1] < 5e-3, seen
    assert (FA.attn_self.launches - launches[0], FA.attn_cross.launches - launches[1]) == (2, 2)


def test_self_attention_launches_are_bitwise_the_recorded_kernel(cuda):
    """The fused FLUX / Qwen-Image attention and the training forward: their
    outputs' digests on numpy-drawn inputs are those recorded in
    ``DIGESTS``, so a change to the mainloop that moves a bit shows here."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import attention_digests
    from textflux_torch.ops.rope import rope_tables_half

    if not DIGESTS:
        pytest.fail("no recorded digests")
    got = attention_digests.digests(torch, FA, rope_tables_half, attention_digests._ids)
    assert got == DIGESTS


def test_eager_captured_and_replayed_forwards_are_bitwise_equal(cuda):
    """Two main blocks and one branch block at the published widths, on the
    cell's larger canvas: the first call runs eagerly, the second captures,
    the third replays; all three bitwise equal, and the hint added."""
    cfg = WanVACEConfig(num_layers=2, vace_layers=(1,))
    dit = WanVACETransformer(cfg, device=cuda, dtype=torch.bfloat16).requires_grad_(False)
    g = torch.Generator(device=cuda).manual_seed(7)
    frames, gh, gw = GRIDS[9880]
    lat = torch.randn(1, frames, 2 * gh, 2 * gw, 16, generator=g, device=cuda).to(torch.bfloat16)
    control = torch.randn(1, frames, 2 * gh, 2 * gw, 96, generator=g, device=cuda).to(
        torch.bfloat16)
    text = torch.randn(1, TEXT, 4096, generator=g, device=cuda).to(torch.bfloat16)
    cos, sin = T.model_rope_tables(dit, rope_ids(frames, gh, gw), cuda)
    with torch.inference_mode():
        mods = step_mods(wan_mods(dit, wan_temb(dit, [0.8], torch.bfloat16, cuda)), 0, 1)
        outs = [dit(lat, control, text, cos, sin, mods=mods, attn_impl="fused")
                for _ in range(3)]
    assert (dit.graphs.captures, dit.graphs.replays, dit.graphs.calls) == (1, 1, 3)
    assert dit.vace_hints == 2
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])
    assert np.isfinite(outs[0].float().cpu().numpy()).all()
