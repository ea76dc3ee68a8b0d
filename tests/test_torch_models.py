"""textflux_torch models held against textflux_tpu models on the JAX
package's own parameters (carried over by load_jax_params), CPU float32:
flux_apply on both tiny configs for the plain and fused paths, with and
without precomputed modulation, and the CLIP and T5 encoders (the VAE is
held in test_torch_pipeline.py, on the tiny pipeline's parameters)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from helpers import CLIP_TINY, FLUX_TINY, FLUX_TINY_WIDE, T5_TINY
from textflux_tpu.config import CLIPTextConfig
from textflux_tpu.models import transformer as JT
from textflux_tpu.models.clip import clip_encode as jax_clip_encode, init_clip_params
from textflux_tpu.models.t5 import (
    init_t5_params,
    relative_position_buckets as jax_buckets,
    t5_encode as jax_t5_encode,
)
from textflux_tpu.ops import packing as JP, rope as JR

from textflux_torch.models import transformer as TT
from textflux_torch.models.clip import clip_encode
from textflux_torch.models.t5 import relative_position_buckets, t5_encode

from torch_port_helpers import n, port_module, t

TOL = dict(atol=1e-4, rtol=1e-4)


def _flux_inputs(cfg, rng, *, b=2, t_txt=6, lat_hw=(8, 10)):
    ids = np.concatenate([JP.text_ids(t_txt), JP.latent_image_ids(*lat_hw)], 0)
    t_img = len(ids) - t_txt
    return dict(
        ids=ids,
        img=rng.standard_normal((b, t_img, cfg.in_channels)).astype(np.float32),
        txt=rng.standard_normal((b, t_txt, cfg.joint_dim)).astype(np.float32),
        pooled=rng.standard_normal((b, cfg.pooled_dim)).astype(np.float32),
        timestep=np.array([0.7, 0.25], np.float32)[:b],
        guidance=np.full((b,), 30.0, np.float32),
    )


@pytest.mark.parametrize("precomputed_mods", [False, True], ids=["mods_inline", "mods_given"])
@pytest.mark.parametrize("impl", ["plain", "fused"])
@pytest.mark.parametrize("cfg", [FLUX_TINY, FLUX_TINY_WIDE], ids=["tiny", "tiny_wide"])
def test_flux_apply_matches_jax(cfg, impl, precomputed_mods, rng):
    params = JT.init_flux_params(jax.random.PRNGKey(3), cfg)
    model = port_module(params, cfg)
    x = _flux_inputs(cfg, rng)
    if impl == "fused":
        params = JT.half_permute_flux_params(params, cfg)
        TT.half_permute_flux_params(model)
        cos, sin = JR.rope_tables_half(x["ids"], cfg.axes_dims_rope)
        jax_impl = "fused"
    else:
        cos, sin = JR.rope_tables(x["ids"], cfg.axes_dims_rope)
        jax_impl = "xla"
    args = (x["img"], x["txt"], x["pooled"], x["timestep"], x["guidance"], cos, sin)
    jax_mods = port_mods = None
    if precomputed_mods:
        vec = JT.flux_vec(params, cfg, x["timestep"], x["guidance"], x["pooled"], jnp.float32)
        jax_mods = JT.flux_mods(params, cfg, vec)
        port_vec = TT.flux_vec(model, t(x["timestep"]), t(x["guidance"]), t(x["pooled"]),
                               torch.float32)
        np.testing.assert_allclose(n(port_vec), np.asarray(vec), **TOL)
        port_mods = TT.flux_mods(model, port_vec)
    ref = JT.flux_apply(params, cfg, *map(jnp.asarray, args), attn_impl=jax_impl, mods=jax_mods)
    with torch.no_grad():
        out = TT.flux_apply(model, *map(t, args), attn_impl=impl, mods=port_mods)
    np.testing.assert_allclose(n(out), np.asarray(ref), **TOL)


def test_half_permute_matches_jax():
    cfg = FLUX_TINY_WIDE
    params = JT.init_flux_params(jax.random.PRNGKey(4), cfg)
    perm = JT.half_permute_flux_params(params, cfg)
    model = TT.half_permute_flux_params(port_module(params, cfg))
    assert model.rope_layout == "half"
    np.testing.assert_array_equal(n(model.double_blocks[0].img_qkv.weight),
                                  np.asarray(perm["double"]["img_qkv"]["w"][0]).T)
    np.testing.assert_array_equal(n(model.single_blocks[0].linear1.weight),
                                  np.asarray(perm["single"]["linear1"]["w"][0]).T)
    np.testing.assert_array_equal(n(model.double_blocks[0].txt_k_scale),
                                  np.asarray(perm["double"]["txt_k_scale"][0]))
    with pytest.raises(ValueError, match="already"):
        TT.half_permute_flux_params(model)


def test_flux_apply_rejects_wrong_layout(rng):
    model = port_module(JT.init_flux_params(jax.random.PRNGKey(0), FLUX_TINY), FLUX_TINY)
    x = _flux_inputs(FLUX_TINY, rng)
    cos, sin = JR.rope_tables_half(x["ids"], FLUX_TINY.axes_dims_rope)
    with pytest.raises(ValueError, match="layout"):
        TT.flux_apply(model, t(x["img"]), t(x["txt"]), t(x["pooled"]), t(x["timestep"]),
                      t(x["guidance"]), t(cos), t(sin), attn_impl="fused")


@pytest.mark.parametrize("legacy_eos", [False, True], ids=["eos_id", "eos_argmax"])
def test_clip_matches_jax(legacy_eos, rng):
    cfg = CLIP_TINY
    ids = rng.integers(3, 90, size=(2, 12))
    if legacy_eos:
        # eos_token_id=2 configs pool at argmax(input_ids) (the EOT id is the
        # vocab's largest); id 2 itself never appears
        cfg = CLIPTextConfig(vocab_size=100, hidden_dim=32, num_layers=2, num_heads=4,
                             mlp_dim=64, max_positions=20, eos_token_id=2)
        ids[:, 0] = 98
        ids[0, 5], ids[0, 6:] = 99, 0
        ids[1, 11] = 99
    else:
        ids[0, 7], ids[1, 11] = 99, 99
    params = init_clip_params(jax.random.PRNGKey(5), cfg)
    h_ref, pooled_ref = jax_clip_encode(params, cfg, jnp.asarray(ids))
    with torch.no_grad():
        h, pooled = clip_encode(port_module(params, cfg), torch.as_tensor(ids))
    np.testing.assert_allclose(n(h), np.asarray(h_ref), **TOL)
    np.testing.assert_allclose(n(pooled), np.asarray(pooled_ref), **TOL)
    if legacy_eos:
        assert not np.allclose(n(pooled), n(h)[:, 0])


def test_t5_matches_jax(rng):
    params = init_t5_params(jax.random.PRNGKey(6), T5_TINY)
    ids = rng.integers(1, 99, size=(2, 10))
    mask = np.ones((2, 10), np.int32)
    mask[1, 7:] = 0
    ref = jax_t5_encode(params, T5_TINY, jnp.asarray(ids), jnp.asarray(mask))
    with torch.no_grad():
        out = t5_encode(port_module(params, T5_TINY), torch.as_tensor(ids),
                        torch.as_tensor(mask))
    np.testing.assert_allclose(n(out), np.asarray(ref), **TOL)


@pytest.mark.parametrize("s,buckets,dist", [(16, 32, 128), (512, 32, 128), (40, 8, 16)])
def test_t5_buckets_exact(s, buckets, dist):
    np.testing.assert_array_equal(n(relative_position_buckets(s, buckets, dist)),
                                  np.asarray(jax_buckets(s, buckets, dist)))
