"""The AdaLN modulate kernel (csrc/adaln_modulate.cu) on the card.

At D = 3,072 and every row count the serving cells meet (1 to 5,248 tokens,
B = 1 and 2), with shift and scale passed as chunks of a block's (B, 6D)
modulation vector and x as the output head's batch-strided slice, the
kernel is held to the composition it replaces, run eagerly on the card:

  * every element within one bf16 place of the composition's normalised
    value, carried through the product and the sum, which round once more
    each (only the float32 summation order of the mean and the variance
    differs, which can move the normalised value by one place);
  * at least 99% of the elements bitwise equal.

Besides: eager, captured and replayed calls bitwise equal; the counter at
115 (FLUX.1-Fill's depth) and 241 (Qwen-Image's) launches an eager forward,
none a replay; a call a gradient flows through, and a float32 call, take
the composition, while the wrapper raises on the card on what the kernel
does not take. These tests carry the ``cuda`` marker and skip without a
CUDA device:

    python -m pytest tests/test_torch_adaln_cuda.py -m cuda -q --noconftest
"""

import pytest
import torch

from textflux_torch.config import FluxConfig, QwenImageConfig
from textflux_torch.models import transformer as T
from textflux_torch.models.layers import layer_norm
from textflux_torch.models.qwen_image import QwenImageTransformer, rope_ids
from textflux_torch.ops import adaln as AM

pytestmark = pytest.mark.cuda

D = 3072
ROWS = (1, 64, 512, 1216, 1664, 3008, 4224, 5248)
BITWISE_SHARE = 0.99


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def inputs(b, s, d, dev, *, skip=0, chunks=6, seed=0):
    """x (B, S, D) past `skip` leading tokens of each sample (the head's
    slice), rows of their own mean and spread as a residual stream has;
    shift and scale the first two chunks of a (B, chunks * D) vector."""
    g = torch.Generator(device=dev).manual_seed(seed)
    spread = 0.5 + 4.0 * torch.rand(b, skip + s, 1, generator=g, device=dev)
    offset = torch.randn(b, skip + s, 1, generator=g, device=dev)
    full = (spread * torch.randn(b, skip + s, d, generator=g, device=dev) + offset)
    mod = 0.5 * torch.randn(b, chunks * d, generator=g, device=dev)
    shift, scale = mod.to(torch.bfloat16).chunk(chunks, dim=-1)[:2]
    return full.to(torch.bfloat16)[:, skip:], shift, scale


def place(v: torch.Tensor) -> torch.Tensor:
    """One bf16 place (unit in the last of 8 significant bits) of |v|."""
    e = torch.floor(torch.log2(v.float().abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


def check(x, shift, scale):
    """The kernel against the eager composition; returns the bitwise share."""
    y = AM.launch(x, shift, scale)
    assert y.is_contiguous() and y.shape == x.shape and y.dtype == torch.bfloat16
    n = layer_norm(x)
    g = 1.0 + scale[:, None]
    p = n * g
    want = p + shift[:, None]
    torch.cuda.synchronize()
    err = (y.float() - want.float()).abs()
    tol = place(n) * g.float().abs() + place(p) + place(want)
    assert bool((err <= tol).all()), f"max err {err.max().item()}, worst {(err / tol).max().item()}"
    share = (y == want).float().mean().item()
    assert share >= BITWISE_SHARE, share
    return share


@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("rows", ROWS)
def test_kernel_matches_the_composition(rows, b, cuda):
    """Each serving row count, the vectors as chunks of a double block's
    (B, 6D) modulation."""
    check(*inputs(b, rows, D, cuda, seed=rows + b))


@pytest.mark.parametrize("b", [1, 2])
def test_the_heads_batch_strided_slice(b, cuda):
    """The output head's x[:, n_txt:] of a joint 1,408 (512 text tokens) goes
    in without a copy, its vectors the (B, 2D) final modulation's chunks;
    a single block's (B, 3D) chunks on the whole joint sequence."""
    x, shift, scale = inputs(b, 896, D, cuda, skip=512, chunks=2, seed=7)
    assert x.storage_offset() == 512 * D and x.stride(0) == 1408 * D
    check(x, shift, scale)
    check(*inputs(b, 1408, D, cuda, chunks=3, seed=8))


def test_layouts_it_refuses_raise_on_the_card(cuda):
    """One (1, D) shift and scale over B = 2, a misaligned view, a row
    stride that is not a multiple of 8 and a strided feature axis raise on
    the card rather than running the composition; vectors expanded to
    (B, D) with a batch stride of 0 are taken."""
    x, shift, scale = inputs(2, 1216, D, cuda, seed=14)
    check(x, shift[:1].expand(2, -1), scale[:1].expand(2, -1))
    with pytest.raises(ValueError, match="shift and scale"):
        AM.adaln_modulate(x, shift[:1], scale[:1])
    wide = torch.zeros(2, 64, D + 4, device=cuda, dtype=torch.bfloat16)
    bad = {"misaligned": (x[:, :, 4:-4], shift[:, 4:-4], scale[:, 4:-4]),
           "row_stride": (wide[:, :, :D], shift, scale),
           "feature_stride": (x[:, :, ::2], shift[:, ::2], scale[:, ::2])}
    before = AM.adaln_modulate.launches
    for name, args in bad.items():
        with pytest.raises(ValueError, match="16-byte aligned"):
            AM.adaln_modulate(*args)
    assert AM.adaln_modulate.launches == before


def test_eager_capture_and_replay_are_bitwise_equal(cuda):
    """Two eager launches, a graph's capture and its replays write the same
    bits; a replay on new inputs copied into the captured buffers is the
    eager call on them. A replay counts no launch."""
    x, shift, scale = (t.clone() for t in inputs(2, 4224, D, cuda, seed=11))
    eager = AM.launch(x, shift, scale)
    assert torch.equal(eager, AM.launch(x, shift, scale))
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = AM.launch(x, shift, scale)
    before = AM.adaln_modulate.launches
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    x2, shift2, scale2 = inputs(2, 4224, D, cuda, seed=12)
    x.copy_(x2)
    shift.copy_(shift2)
    scale.copy_(scale2)
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    assert AM.adaln_modulate.launches == before
    assert torch.equal(out, AM.launch(x2, shift2, scale2))


def test_gradient_and_float32_calls_take_the_composition(cuda):
    """A ``_modulate`` a gradient flows through returns the composition
    bitwise, with its gradient, and launches nothing; so does a float32
    one, which ``adaln_modulate`` itself refuses on the card (TypeError).
    The same bf16 tensors without a gradient launch the kernel once."""
    x, shift, scale = inputs(1, 512, D, cuda, seed=13)
    before = AM.adaln_modulate.launches
    xg = x.detach().clone().requires_grad_(True)
    y = T._modulate(xg, shift, scale)
    want = layer_norm(x) * (1.0 + scale[:, None]) + shift[:, None]
    assert torch.equal(y.detach(), want)
    y.float().sum().backward()
    assert xg.grad is not None and bool(torch.isfinite(xg.grad).all())
    xf = x.float()
    assert torch.equal(T._modulate(xf, shift.float(), scale.float()),
                       layer_norm(xf) * (1.0 + scale.float()[:, None]) + shift.float()[:, None])
    with pytest.raises(TypeError, match="bfloat16"):
        AM.adaln_modulate(xf, shift.float(), scale.float())
    with pytest.raises(ValueError, match="no backward"):
        AM.adaln_modulate(xg, shift, scale)
    assert AM.adaln_modulate.launches == before
    with torch.no_grad():
        T._modulate(xg, shift, scale)
    assert AM.adaln_modulate.launches == before + 1


def _small_flux(dev):
    """FLUX.1-Fill's depth (19 double, 38 single blocks) at two 128-wide
    heads: the modulates a forward makes depend on the depth alone."""
    cfg = FluxConfig(in_channels=64, out_channels=16, num_heads=2, head_dim=128, joint_dim=64,
                     pooled_dim=32)
    assert (cfg.num_double_layers, cfg.num_single_layers) == (19, 38)
    return T.FluxTransformer(cfg, device=dev, dtype=torch.bfloat16).requires_grad_(False)


def test_launches_per_eager_forward(cuda):
    """115 launches an eager FLUX forward at its published depth and 241 a
    Qwen-Image one (60 double blocks); through the serving graph the
    capture counts 115 and a replay none, bitwise the eager velocity."""
    flux = _small_flux(cuda)
    T.to_attn_layout(flux, "fused")
    g = torch.Generator(device=cuda).manual_seed(0)
    n_txt, n_img = 64, 256
    ids = torch.zeros(n_txt + n_img, 3).numpy()
    cos, sin = T.model_rope_tables(flux, ids, cuda)
    img = torch.randn(1, n_img, 64, generator=g, device=cuda).to(torch.bfloat16)
    txt = torch.randn(1, n_txt, 64, generator=g, device=cuda).to(torch.bfloat16)
    pooled = torch.randn(1, 32, generator=g, device=cuda).to(torch.bfloat16)
    t, guid = torch.tensor([0.5], device=cuda), torch.tensor([30.0], device=cuda)
    with torch.inference_mode():
        mods = T.flux_mods(flux, T.flux_vec(flux, t, guid, pooled))
        counts, outs = [], []
        for _ in range(3):          # eager, captured, replayed
            before = AM.adaln_modulate.launches
            outs.append(T.flux_apply(flux, img, txt, pooled, t, guid, cos, sin,
                                     attn_impl="fused", mods=mods))
            counts.append(AM.adaln_modulate.launches - before)
    assert (flux.graphs.captures, flux.graphs.replays) == (1, 1)
    assert counts == [115, 115, 0]
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])
    del flux

    cfg = QwenImageConfig(num_heads=2, head_dim=128, joint_dim=64)
    qwen = QwenImageTransformer(cfg, device=cuda, dtype=torch.bfloat16).requires_grad_(False)
    T.to_attn_layout(qwen, "fused")
    grid = (16, 16)
    cos, sin = T.model_rope_tables(qwen, rope_ids(*grid, n_txt), cuda)
    x = torch.randn(1, grid[0] * grid[1], 64, generator=g, device=cuda).to(torch.bfloat16)
    with torch.inference_mode():
        mods = T.flux_mods(qwen, torch.randn(1, 256, generator=g, device=cuda)
                           .to(torch.bfloat16))
        before = AM.adaln_modulate.launches
        qwen._forward(x, txt, cos, sin, attn_impl="fused", kv_len=None, mods=mods)
    assert AM.adaln_modulate.launches - before == 241
