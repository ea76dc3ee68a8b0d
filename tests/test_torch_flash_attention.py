"""The port's flash attention (the plain versions of the four training
kernels, and the autograd function over them) held against the JAX
package's Pallas flash attention and backward, run in interpret mode on the
CPU as tests/test_flash_attention.py runs them, and against autodiff through
the plain attention on both sides. CPU, float32, inputs from numpy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from textflux_tpu.ops.attention import _xla_attention
from textflux_tpu.ops.flash_attention import flash_attention as jax_flash
from textflux_tpu.ops.flash_attention import flash_attention_bwd as jax_flash_bwd

from textflux_torch.ops import flash_attention as FA
from textflux_torch.ops.attention import FlashAttention, dot_product_attention, plain_attention

from torch_port_helpers import n, t


def _qkv(rng, *shape, extra=0):
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3 + extra)]


@pytest.mark.parametrize("shape,kv_len", [
    ((1, 256, 2, 128), None),
    ((2, 300, 3, 64), None),
    ((1, 200, 2, 64), 150),
], ids=["s256_d128", "ragged_s300_d64", "kv_len150"])
def test_forward_matches_pallas(shape, kv_len, rng):
    q, k, v = _qkv(rng, *shape)
    got = FA.flash_attention(t(q), t(k), t(v), kv_len=kv_len)
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kv_len=kv_len,
                     interpret=True)
    np.testing.assert_allclose(n(got), np.asarray(want), atol=2e-5)


def test_lse_matches_logsumexp(rng):
    """Pass 1 (natural-log L, keys >= kv_len masked) against JAX's
    logsumexp of the masked, scaled logits."""
    q, k, _ = _qkv(rng, 1, 96, 2, 32)
    got = FA.flash_attention_lse(t(q), t(k), kv_len=80)
    logits = jnp.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(32.0)
    logits = jnp.where(jnp.arange(96) < 80, logits, -1e30)
    np.testing.assert_allclose(n(got), np.asarray(jax.nn.logsumexp(logits, axis=-1)),
                               atol=1e-5)


@pytest.mark.parametrize("shape,kv_len", [((1, 200, 2, 64), None), ((1, 256, 2, 64), 200)],
                         ids=["s200", "kv_len200_of_256"])
def test_backward_matches_pallas(shape, kv_len, rng):
    """flash_attention_bwd against the Pallas backward kernels (and, on the
    key rows >= kv_len the JAX test leaves out, against zero)."""
    q, k, v, do = _qkv(rng, *shape, extra=1)
    o = FA.flash_attention(t(q), t(k), t(v), kv_len=kv_len)
    got = FA.flash_attention_bwd(t(q), t(k), t(v), o, t(do), kv_len=kv_len)
    want = jax_flash_bwd(*(jnp.asarray(x) for x in (q, k, v, do)), kv_len=kv_len,
                         block_q=128, block_k=128, interpret=True)
    real = shape[1] if kv_len is None else kv_len
    np.testing.assert_allclose(n(got[0]), np.asarray(want[0]), atol=2e-4)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(n(g)[:, :real], np.asarray(w)[:, :real], atol=2e-4)
        assert not n(g)[:, real:].any()


@pytest.mark.parametrize("kv_len", [None, 120])
def test_autograd_function_matches_autodiff(kv_len, rng):
    """The Function's gradients against torch.autograd through
    plain_attention and against jax.vjp of _xla_attention, S=160."""
    q, k, v, do = _qkv(rng, 2, 160, 2, 32, extra=1)
    qt, kt, vt = (t(x).requires_grad_() for x in (q, k, v))
    out = FlashAttention.apply(qt, kt, vt, kv_len)
    grads = torch.autograd.grad(out, (qt, kt, vt), t(do))

    qp, kp, vp = (t(x).requires_grad_() for x in (q, k, v))
    ref = plain_attention(qp, kp, vp, kv_len=kv_len)
    ref_grads = torch.autograd.grad(ref, (qp, kp, vp), t(do))
    _, vjp = jax.vjp(lambda a, b, c: _xla_attention(a, b, c, kv_len=kv_len),
                     *(jnp.asarray(x) for x in (q, k, v)))
    jax_grads = vjp(jnp.asarray(do))

    np.testing.assert_allclose(n(out), n(ref), atol=1e-5)
    for g, r, j in zip(grads, ref_grads, jax_grads):
        np.testing.assert_allclose(n(g), n(r), atol=1e-4)
        np.testing.assert_allclose(n(g), np.asarray(j), atol=1e-4)


def test_plain_versions_repeat_the_kernel_roundings(rng):
    """In bf16 the plain versions round P and dS to v's dtype before their
    products, as the kernels do; in fp32 those roundings vanish and the
    result matches autodiff of plain attention."""
    q, k, v, do = (t(x) for x in _qkv(rng, 1, 64, 2, 32, extra=1))
    o = FA.flash_attention(q, k, v)
    lse = FA.flash_attention_lse(q, k)
    dvec = FA.attention_dvec(o, do)
    bf = [x.to(torch.bfloat16) for x in (q, k, v, do)]
    dq16 = FA.flash_attention_dq(*bf, lse, dvec)
    dk16, dv16 = FA.flash_attention_dkv(*bf, lse, dvec)
    assert dq16.dtype == dk16.dtype == dv16.dtype == torch.bfloat16
    dq = FA.flash_attention_dq(q, k, v, do, lse, dvec)
    dk, dv = FA.flash_attention_dkv(q, k, v, do, lse, dvec)
    for lo, hi in ((dq16, dq), (dk16, dk), (dv16, dv)):
        scale = float(hi.abs().max())
        assert float((lo.float() - hi).abs().max()) <= 3e-2 * scale


def test_cpu_tensors_count_no_launch(rng):
    q, k, v, do = (t(x).requires_grad_(i < 3) for i, x in enumerate(_qkv(rng, 1, 40, 2, 16,
                                                                             extra=1)))
    before = [getattr(FA, name).launches for name in
              ("flash_attention", "flash_attention_lse", "flash_attention_dq",
               "flash_attention_dkv")]
    out = dot_product_attention(q, k, v, impl="flash")
    out.backward(do)
    after = [getattr(FA, name).launches for name in
             ("flash_attention", "flash_attention_lse", "flash_attention_dq",
              "flash_attention_dkv")]
    assert after == before
    assert q.grad is not None and torch.isfinite(q.grad).all()


def test_dispatch(rng):
    q, k, v = (t(x) for x in _qkv(rng, 1, 24, 2, 16))
    auto = dot_product_attention(q, k, v, kv_len=20)
    np.testing.assert_array_equal(n(auto), n(plain_attention(q, k, v, kv_len=20)))
    flash = dot_product_attention(q, k, v, impl="flash", kv_len=20)
    np.testing.assert_allclose(n(flash), n(auto), atol=1e-6)
    with pytest.raises(ValueError, match="impl"):
        dot_product_attention(q, k, v, impl="pallas")
    with pytest.raises(ValueError, match="kv_len"):
        FA.flash_attention(q, k, v, kv_len=0)
