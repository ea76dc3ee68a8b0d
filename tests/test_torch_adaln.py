"""The AdaLN modulate on the CPU: the DiT's ``_modulate`` (through
``ops.adaln.adaln_modulate``) returns bitwise the composition it has always
run, with its gradients, and never counts a kernel launch; the wrapper
raises on what the kernel does not take; a forward makes one modulate a
double block's stream and sublayer, one a single block and one for the head.
The kernel itself runs on the card (``tests/test_torch_adaln_cuda.py``)."""

import numpy as np
import pytest
import torch

from textflux_torch.config import FluxConfig, QwenImageConfig, flux_fill_config
from textflux_torch.models import transformer as T
from textflux_torch.models.layers import layer_norm
from textflux_torch.models.qwen_image import QwenImageTransformer, qwen_apply, rope_ids
from textflux_torch.ops import adaln as AM


def composition(x, shift, scale):
    """What ``_modulate`` computed before the kernel existed."""
    return layer_norm(x) * (1.0 + scale[:, None]) + shift[:, None]


def inputs(b, s, d, dtype, *, skip=0, chunks=6, seed=0):
    """x (B, S, D) as the head's slice past `skip` leading tokens (a batch
    stride of (skip + S) * D), and shift, scale as the first two chunks of a
    (B, chunks * D) modulation vector, all with a non-zero mean."""
    g = torch.Generator().manual_seed(seed)
    full = (3.0 * torch.randn(b, skip + s, d, generator=g) + 0.7).to(dtype)
    mod = (0.3 * torch.randn(b, chunks * d, generator=g) + 0.1).to(dtype)
    shift, scale = mod.chunk(chunks, dim=-1)[:2]
    return full[:, skip:], shift, scale


CASES = [(1, 1, 64, 0, 6), (2, 7, 96, 0, 6), (2, 5, 256, 3, 2), (1, 33, 3072, 0, 3),
         (2, 9, 3072, 4, 2)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,s,d,skip,chunks", CASES,
                         ids=[f"b{b}-s{s}-d{d}-skip{k}-of{c}" for b, s, d, k, c in CASES])
def test_cpu_modulate_is_the_composition(b, s, d, skip, chunks, dtype):
    """Contiguous rows and the head's batch-strided slice, the vectors as
    chunks of a double block's (6D), a single block's (3D) or the head's
    (2D) modulation: bitwise the composition, under no_grad and
    inference_mode as well, and no kernel launch counted."""
    x, shift, scale = inputs(b, s, d, dtype, skip=skip, chunks=chunks)
    before = AM.adaln_modulate.launches
    want = composition(x, shift, scale)
    for ctx in (torch.enable_grad, torch.no_grad, torch.inference_mode):
        with ctx():
            got = T._modulate(x, shift, scale)
        assert got.dtype == dtype and got.shape == (b, s, d)
        assert torch.equal(got, want)
        assert torch.equal(AM.adaln_modulate(x, shift, scale), want)
    assert torch.equal(AM.adaln_modulate_reference(x, shift, scale), want)
    assert AM.adaln_modulate.launches == before == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("wrt", ["x", "all"])
def test_cpu_gradients_are_the_composition(dtype, wrt):
    """Where a gradient flows, the output and the gradients of x (and of the
    vectors) are bitwise the composition's."""
    x0, shift0, scale0 = inputs(2, 6, 128, dtype, skip=2, chunks=6, seed=3)
    dy = torch.randn(2, 6, 128, generator=torch.Generator().manual_seed(4)).to(dtype)
    grads = []
    for fn in (T._modulate, composition):
        x, shift, scale = (t.detach().clone() for t in (x0, shift0, scale0))
        leaves = [x] if wrt == "x" else [x, shift, scale]
        for t in leaves:
            t.requires_grad_(True)
        y = fn(x, shift, scale)
        y.backward(dy)
        grads.append([y.detach()] + [t.grad for t in leaves])
    for got, want in zip(*grads):
        assert torch.equal(got, want)
    assert AM.adaln_modulate.launches == 0


def _refused(case):
    x, shift, scale = inputs(1, 4, 64, torch.bfloat16)
    if case == "float32":
        x = x.float()
    elif case == "d_not_multiple_of_8":
        x, shift, scale = inputs(1, 4, 100, torch.bfloat16)
    elif case == "d_above_8192":
        x, shift, scale = inputs(1, 2, 8200, torch.bfloat16, chunks=2)
    elif case == "vector_shape":
        shift = shift[:, :32]
    elif case == "x_not_3d":
        x = x[0]
    return x, shift, scale


REFUSALS = [("float32", TypeError, "bfloat16"),
            ("d_not_multiple_of_8", ValueError, "multiple of 8"),
            ("d_above_8192", ValueError, "up to 8192"),
            ("cpu", ValueError, "CUDA"),
            ("vector_shape", ValueError, "shift and scale"),
            ("x_not_3d", ValueError, "B, S, D")]


@pytest.mark.parametrize("case,exc,match", REFUSALS, ids=[c for c, _, _ in REFUSALS])
def test_the_wrapper_refuses_what_the_kernel_cannot_take(case, exc, match):
    """``launch`` raises on the dtype, D % 8, D > 8,192, the device and the
    shapes (a bf16 CPU call of a shape the kernel takes is refused for its
    device), as ``adaln_modulate`` does on a CUDA tensor; on these CPU
    tensors ``adaln_modulate`` runs the composition where it can compute
    one, and counts nothing."""
    x, shift, scale = _refused(case)
    with pytest.raises(exc, match=match):
        AM.launch(x, shift, scale)
    if case not in ("vector_shape", "x_not_3d"):
        assert torch.equal(AM.adaln_modulate(x, shift, scale), composition(x, shift, scale))
    assert AM.adaln_modulate.launches == 0


def test_max_dim_is_the_largest_instantiation():
    """32 16-byte vectors a lane of a warp: 8,192 bf16 features."""
    assert AM.MAX_DIM == 8192 and 3072 <= AM.MAX_DIM


def _count_modulates(monkeypatch, forward) -> int:
    calls = []
    inner = T._modulate

    def spy(x, shift, scale):
        calls.append(x.shape)
        return inner(x, shift, scale)

    monkeypatch.setattr(T, "_modulate", spy)
    with torch.inference_mode():
        forward()
    return len(calls)


def expected_modulates(cfg) -> int:
    """Modulates a forward makes: 4 a double block (two streams, before the
    attention and before the MLP), 1 a single block, 1 the output head."""
    return 4 * cfg.num_double_layers + getattr(cfg, "num_single_layers", 0) + 1


def test_a_forward_makes_one_modulate_a_block_sublayer_and_the_head(monkeypatch):
    """A tiny FLUX DiT (2 double, 3 single blocks) and a tiny Qwen-Image DiT
    (3 double blocks) call ``_modulate`` as often as ``expected_modulates``
    counts; at the published depths that is 115 (FLUX.1-Fill) and 241
    (Qwen-Image), the launches a forward on the card counts."""
    cfg = FluxConfig(in_channels=12, out_channels=8, num_double_layers=2, num_single_layers=3,
                     num_heads=2, head_dim=8, joint_dim=16, pooled_dim=8,
                     axes_dims_rope=(4, 2, 2))
    flux = T.FluxTransformer(cfg, device="cpu")
    g = torch.Generator().manual_seed(0)
    n_txt, n_img = 3, 5
    cos, sin = T.model_rope_tables(flux, np.zeros((n_txt + n_img, 3)), "cpu")
    args = (torch.randn(1, n_img, 12, generator=g), torch.randn(1, n_txt, 16, generator=g),
            torch.randn(1, 8, generator=g), torch.tensor([0.5]), torch.tensor([30.0]), cos, sin)
    assert _count_modulates(monkeypatch, lambda: T.flux_apply(flux, *args)) == 12
    assert expected_modulates(cfg) == 12

    qcfg = QwenImageConfig(in_channels=8, out_channels=8, num_double_layers=3, num_heads=2,
                           head_dim=8, joint_dim=16, axes_dims_rope=(4, 2, 2))
    qwen = QwenImageTransformer(qcfg, device="cpu")
    cos, sin = T.model_rope_tables(qwen, rope_ids(2, 2, n_txt), "cpu")
    x, txt = torch.randn(1, 4, 8, generator=g), torch.randn(1, n_txt, 16, generator=g)
    with torch.inference_mode():
        mods = T.flux_mods(qwen, torch.randn(1, 16, generator=g))
    assert _count_modulates(monkeypatch, lambda: qwen_apply(qwen, x, txt, cos, sin, mods=mods,
                                                            attn_impl="plain")) == 13
    assert expected_modulates(qcfg) == 13
    assert expected_modulates(flux_fill_config()) == 115
    assert expected_modulates(QwenImageConfig()) == 241
