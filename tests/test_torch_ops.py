"""textflux_torch ops held against textflux_tpu ops on the same numpy inputs
(CPU, float32): packing and RoPE ids/tables and the sigma schedule exactly,
samplers given the same noise to 1e-6, layers and attention closely, and the
fused attention's plain version against the Pallas kernel (interpret mode)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from textflux_tpu.models import layers as JL
from textflux_tpu.ops import packing as JP, rope as JR, samplers as JS
from textflux_tpu.ops.attention import _xla_attention
from textflux_tpu.ops.flash_attention import flash_attention_qk_norm_rope as jax_fused

from textflux_torch.models import layers as TL
from textflux_torch.ops import flash_attention as TF, packing as TP, rope as TR, samplers as TS
from textflux_torch.ops.attention import plain_attention

from torch_port_helpers import n, t


def test_packing_exact(rng):
    lat = rng.standard_normal((2, 8, 12, 4)).astype(np.float32)
    mask = (rng.random((2, 64, 96)) > 0.5).astype(np.float32)
    np.testing.assert_array_equal(n(TP.pack_latents(t(lat))), np.asarray(JP.pack_latents(lat)))
    tok = np.asarray(JP.pack_latents(lat))
    np.testing.assert_array_equal(n(TP.unpack_latents(t(tok), 8, 12)), lat)
    np.testing.assert_array_equal(n(TP.pack_mask(t(mask), 8)), np.asarray(JP.pack_mask(mask, 8)))
    np.testing.assert_array_equal(TP.latent_image_ids(56, 64), JP.latent_image_ids(56, 64))
    np.testing.assert_array_equal(TP.text_ids(512), JP.text_ids(512))


def test_rope_tables_exact(rng):
    ids = np.concatenate([JP.text_ids(7), JP.latent_image_ids(12, 10)], 0)
    for fn in ("rope_tables", "rope_tables_half"):
        for a, b in zip(getattr(TR, fn)(ids, (16, 56, 56)), getattr(JR, fn)(ids, (16, 56, 56))):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(TR.half_permutation(128), JR.half_permutation(128))
    cos, sin = JR.rope_tables(ids, (4, 2, 2))
    x = rng.standard_normal((2, len(ids), 3, 8)).astype(np.float32)
    np.testing.assert_allclose(n(TR.apply_rope_bshd(t(x), t(cos), t(sin))),
                               np.asarray(JR.apply_rope_bshd(x, cos, sin)), atol=1e-6)


def test_schedule_exact():
    for steps, seq in ((30, 896), (4, 4096), (1, 96)):
        np.testing.assert_array_equal(TS.make_schedule(steps, seq), JS.make_schedule(steps, seq))
        assert TS.calculate_shift(seq) == JS.calculate_shift(seq)
    np.testing.assert_array_equal(
        TS.make_schedule(8, use_dynamic_shifting=False, shift=3.0),
        JS.make_schedule(8, use_dynamic_shifting=False, shift=3.0))


@pytest.mark.parametrize("sampler", ["euler", "overshoot", "overshoot_spatial", "scale_noise"])
def test_samplers_given_noise(sampler, rng):
    import jax

    x = rng.standard_normal((2, 24, 16)).astype(np.float32)
    v = rng.standard_normal((2, 24, 16)).astype(np.float32)
    sig = JS.make_schedule(4, 24)
    s0, s1 = jnp.float32(sig[1]), jnp.float32(sig[2])
    key = jax.random.PRNGKey(3)
    keys = jax.random.split(key, 2)
    if sampler == "euler":
        ref = JS.euler_step(x, v, s0, s1)
        out = TS.euler_step(t(x), t(v), sig[1], sig[2])
    elif sampler == "scale_noise":
        ref = JS.scale_noise(x, s0, v)
        out = TS.scale_noise(t(x), torch.tensor(sig[1]), t(v))
    else:
        # the JAX pipeline vmaps the step over the batch with one key each
        noise = np.stack([np.asarray(jax.random.normal(k, x.shape[1:], jnp.float32))
                          for k in keys])
        if sampler == "overshoot":
            ref = jax.vmap(lambda l, u, k: JS.overshoot_step(l, u, s0, s1, k, c=2.5))(x, v, keys)
            out = TS.overshoot_step(t(x), t(v), sig[1], sig[2], t(noise), c=2.5)
        else:
            c_map = (rng.random((2, 24)) * 3).astype(np.float32)
            ref = jax.vmap(lambda l, u, k, cm: JS.overshoot_step_spatial(
                l, u, s0, s1, k, cm))(x, v, keys, c_map)
            out = TS.overshoot_step_spatial(t(x), t(v), sig[1], sig[2], t(c_map), t(noise))
    np.testing.assert_allclose(n(out), np.asarray(ref), atol=1e-6)


def test_overshoot_draws_from_generator(rng):
    x = t(rng.standard_normal((1, 8, 4)))
    g1, g2 = torch.Generator().manual_seed(1), torch.Generator().manual_seed(1)
    a = TS.overshoot_step(x, x, 0.8, 0.6, generator=g1)
    b = TS.overshoot_step(x, x, 0.8, 0.6, torch.randn(x.shape, generator=g2))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError):
        TS.overshoot_step(x, x, 0.8, 0.6)


def test_layers_match(rng):
    x = rng.standard_normal((2, 5, 16)).astype(np.float32) * 3
    scale = rng.standard_normal(16).astype(np.float32)
    pairs = [
        (TL.layer_norm(t(x)), JL.layer_norm(x)),
        (TL.rms_norm(t(x), t(scale)), JL.rms_norm(x, scale)),
        (TL.gelu_tanh(t(x)), JL.gelu_tanh(x)),
        (TL.silu(t(x)), JL.silu(x)),
        (TL.quick_gelu(t(x)), JL.quick_gelu(x)),
    ]
    for ours, ref in pairs:
        np.testing.assert_allclose(n(ours), np.asarray(ref), atol=1e-5, rtol=1e-6)
    # arguments reach ~1e3 (sigma * 1000): fp32 sin/cos of XLA and PyTorch
    # differ by a few ulps of the argument there (ulp(971) ~ 6e-5)
    np.testing.assert_allclose(n(TL.timestep_embedding(t(np.array([0.3, 971.0])), 256)),
                               np.asarray(JL.timestep_embedding(jnp.asarray([0.3, 971.0]), 256)),
                               atol=1e-4)
    w = rng.standard_normal((16, 8)).astype(np.float32)
    b = rng.standard_normal(8).astype(np.float32)
    lin = TL.make_linear(16, 8, device="cpu")
    with torch.no_grad():
        lin.weight.copy_(t(w).T)
        lin.bias.copy_(t(b))
    np.testing.assert_allclose(n(TL.dense(lin, t(x))), np.asarray(JL.dense({"w": w, "b": b}, x)),
                               atol=1e-5)


@pytest.mark.parametrize("kv_len", [None, 150])
def test_plain_attention_matches_xla(kv_len, rng):
    q, k, v = (rng.standard_normal((2, 200, 3, 32)).astype(np.float32) for _ in range(3))
    ref = _xla_attention(q, k, v, kv_len=kv_len)
    out = plain_attention(t(q), t(k), t(v), kv_len=kv_len)
    np.testing.assert_allclose(n(out), np.asarray(ref), atol=1e-5)


def _fused_case(rng, *, d, axes, t_txt, lat_hw, per_row):
    ids = np.concatenate([JP.text_ids(t_txt), JP.latent_image_ids(*lat_hw)], 0)
    s = len(ids)
    q, k, v = (rng.standard_normal((1, s, 2, d)).astype(np.float32) for _ in range(3))
    cos, sin = JR.rope_tables_half(ids, axes)
    if per_row:   # double-block tables: txt rows and img rows differ
        qs = np.concatenate([np.broadcast_to(rng.standard_normal(d) * 0.1 + 1, (t_txt, d)),
                             np.broadcast_to(rng.standard_normal(d) * 0.1 + 1, (s - t_txt, d))])
        ks = np.concatenate([np.broadcast_to(rng.standard_normal(d) * 0.1 + 1, (t_txt, d)),
                             np.broadcast_to(rng.standard_normal(d) * 0.1 + 1, (s - t_txt, d))])
    else:
        qs, ks = rng.standard_normal(d) * 0.1 + 1, rng.standard_normal(d) * 0.1 + 1
    return q, k, v, cos, sin, qs.astype(np.float32), ks.astype(np.float32)


@pytest.mark.parametrize("case", [
    dict(d=128, axes=(16, 56, 56), t_txt=8, lat_hw=(16, 16), per_row=False, kv_len=None),
    dict(d=128, axes=(16, 56, 56), t_txt=24, lat_hw=(16, 14), per_row=True, kv_len=None),
    dict(d=128, axes=(16, 56, 56), t_txt=8, lat_hw=(32, 32), per_row=True, kv_len=200),
    dict(d=64, axes=(16, 24, 24), t_txt=16, lat_hw=(20, 20), per_row=False, kv_len=100),
], ids=["d128_txt_img", "d128_per_row_scales", "d128_kv_len", "d64"])
def test_fused_reference_matches_pallas(case, rng):
    """The port's plain version of the fused kernel against the JAX package's
    Pallas kernel, run in interpret mode on the CPU."""
    kv_len = case.pop("kv_len")
    q, k, v, cos, sin, qs, ks = _fused_case(rng, **case)
    ref = jax_fused(q, k, v, cos, sin, qs, ks, kv_len=kv_len, block_q=128, block_k=128)
    out = TF.flash_attention_qk_norm_rope_reference(
        t(q), t(k), t(v), t(cos), t(sin), t(qs), t(ks), kv_len=kv_len)
    rows = slice(None) if kv_len is None else slice(0, kv_len)
    np.testing.assert_allclose(n(out)[:, rows], np.asarray(ref)[:, rows], atol=3e-5)
    # on CPU tensors the wrapper runs exactly the plain version
    wrapped = TF.flash_attention_qk_norm_rope(
        t(q), t(k), t(v), t(cos), t(sin), t(qs), t(ks), kv_len=kv_len)
    torch.testing.assert_close(wrapped, out, rtol=0, atol=0)


def test_fused_equals_norm_rope_then_attention(rng):
    """Permuted layout + rotate-half tables == rms_norm + interleaved rope +
    plain attention on the original layout."""
    b, h, d, axes = 1, 2, 128, (16, 56, 56)
    ids = np.concatenate([JP.text_ids(8), JP.latent_image_ids(16, 16)], 0)
    s = len(ids)
    q, k, v = (t(rng.standard_normal((b, s, h, d))) for _ in range(3))
    qs, ks = (t(rng.standard_normal(d) * 0.1 + 1) for _ in range(2))
    cos, sin = (t(x) for x in TR.rope_tables(ids, axes))
    ref = plain_attention(TR.apply_rope_bshd(TL.rms_norm(q, qs), cos, sin),
                          TR.apply_rope_bshd(TL.rms_norm(k, ks), cos, sin), v)
    perm = torch.as_tensor(TR.half_permutation(d))
    cos_h, sin_h = (t(x) for x in TR.rope_tables_half(ids, axes))
    out = TF.flash_attention_qk_norm_rope(q[..., perm], k[..., perm], v, cos_h, sin_h,
                                          qs[perm], ks[perm])
    torch.testing.assert_close(out, ref, atol=3e-5, rtol=0)


def test_kernel_launch_rejects_cpu_tensors(rng):
    """The CUDA launch path never computes on the CPU: it raises."""
    q = t(rng.standard_normal((1, 64, 2, 64))).to(torch.bfloat16)
    tables = TF.fold_tables(torch.ones(64, 64), torch.zeros(64, 64), torch.ones(64),
                            torch.ones(64))
    before = TF.flash_attention_qk_norm_rope.launches
    with pytest.raises(ValueError, match="CUDA"):
        TF.launch_folded(q, q, q, *tables, kv_len=64)
    assert TF.flash_attention_qk_norm_rope.launches == before
