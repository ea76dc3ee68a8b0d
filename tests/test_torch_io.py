"""The port's checkpoint IO held against the safetensors package and the JAX
package: the safetensors reader and writer (bitwise, both ways), the
converters (bitwise against the JAX converters + load_jax_params, every key
of the real checkpoints consumed), the config checks, the LoRA fold, the
exporters, and an export -> load round trip. CPU, float32, tiny widths."""

import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from safetensors import safe_open
from safetensors.torch import save_file as st_save_file

from helpers import FLUX_TINY
from textflux_tpu.config import CLIPTextConfig, FluxConfig, T5Config, VAEConfig
from textflux_tpu.io import export as JE, lora as JL, params as JPa
from textflux_tpu.models import transformer as JT
from textflux_tpu.ops import packing as JP, rope as JR
from textflux_tpu.training.train import lora_init as jax_lora_init

from textflux_torch.io import export as TE, lora as TL, params as TP
from textflux_torch.io.from_jax import load_jax_lora
from textflux_torch.io.safetensors import SafetensorsFile, save_file
from textflux_torch.models import transformer as TT

from torch_port_helpers import n, port_cfg, port_module, t

HERE = os.path.dirname(__file__)
with open(os.path.join(HERE, "golden", "checkpoint_manifest.json")) as _f:
    MANIFEST = json.load(_f)

# real layer counts, tiny widths (key names depend only on the structure)
FLUX_REAL_DEPTH = FluxConfig(in_channels=12, out_channels=4, num_double_layers=19,
                             num_single_layers=38, num_heads=2, head_dim=4, joint_dim=8,
                             pooled_dim=6, time_embed_channels=8)
# the real (128, 256, 512, 512) channel pattern (differ, differ, same) keeps
# conv_shortcut where the real VAE has it; 16 latent channels as the real one
VAE_REAL_DEPTH = VAEConfig(block_out_channels=(8, 16, 32, 32), layers_per_block=2,
                           latent_channels=16, norm_num_groups=4)
CLIP_REAL_DEPTH = CLIPTextConfig(vocab_size=64, hidden_dim=16, num_layers=12, num_heads=2,
                                 mlp_dim=32, max_positions=77)
T5_REAL_DEPTH = T5Config(vocab_size=64, d_model=16, d_kv=4, d_ff=32, num_layers=24,
                         num_heads=4, relative_attention_num_buckets=8,
                         relative_attention_max_distance=16)
# real dim -> tiny dim, per component (a function of the real dim alone)
DIM_MAPS = {
    "vae": {1: 1, 3: 3, 16: 16, 32: 32, 128: 8, 256: 16, 512: 32},
    "clip": {49408: 64, 768: 16, 3072: 32, 77: 77},
    "t5": {32128: 64, 4096: 16, 10240: 32, 32: 8, 64: 4},
}
TINY_CFGS = {"vae": VAE_REAL_DEPTH, "clip": CLIP_REAL_DEPTH, "t5": T5_REAL_DEPTH}
JAX_CONVERT = {"vae": JPa.convert_vae_state_dict, "clip": JPa.convert_clip_state_dict,
               "t5": JPa.convert_t5_state_dict}


def manifest_state_dict(component: str, seed: int = 0) -> dict:
    """Every key of a real checkpoint, at tiny dims, with random values."""
    rng = np.random.default_rng(seed)
    dims = DIM_MAPS[component]
    return {k: rng.standard_normal([dims[x] for x in shape]).astype(np.float32)
            for k, shape in MANIFEST[component].items()}


def assert_modules_equal(a, b):
    pa, pb = dict(a.named_parameters()), dict(b.named_parameters())
    assert pa.keys() == pb.keys()
    for k in pa:
        assert torch.equal(pa[k].detach(), pb[k].detach()), k


@pytest.fixture(scope="module")
def real_depth_params():
    return JT.init_flux_params(jax.random.PRNGKey(6), FLUX_REAL_DEPTH)


def jax_flux_sd(cfg, seed=0):
    """A diffusers-naming DiT state dict from the JAX package's init and exporter."""
    params = JT.init_flux_params(jax.random.PRNGKey(seed), cfg)
    return params, JE.export_flux_state_dict(params, cfg)


def _torch_sd(sd):
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()}


# ---------------------------------------------------------------------------
# safetensors
# ---------------------------------------------------------------------------

ST_DTYPES = [torch.bfloat16, torch.float16, torch.float32, torch.float64, torch.int64,
             torch.int32, torch.int8, torch.uint8, torch.bool]


def _sample_tensors(seed=0):
    g = torch.Generator().manual_seed(seed)
    out = {}
    for i, dt in enumerate(ST_DTYPES):
        x = torch.randn(3, 5 + i, generator=g) * 50
        out[f"t.{i}.{str(dt).split('.')[-1]}"] = (x > 0) if dt == torch.bool else x.to(dt)
    out["scalar"] = torch.tensor(2.5, dtype=torch.float32)
    out["empty"] = torch.zeros((0, 4), dtype=torch.bfloat16)
    return out


def _bits(x):
    return x.contiguous().reshape(-1).view(torch.uint8)


def test_reader_matches_safetensors_package(tmp_path):
    tensors = _sample_tensors()
    path = str(tmp_path / "a.safetensors")
    st_save_file(tensors, path, metadata={"format": "pt", "note": "x"})
    with SafetensorsFile(path) as f:
        assert set(f.keys()) == set(tensors)
        assert f.metadata() == {"format": "pt", "note": "x"}
        got = {k: f.get_tensor(k) for k in f.keys()}
    for k, want in tensors.items():
        assert got[k].dtype == want.dtype and got[k].shape == want.shape, k
        assert torch.equal(_bits(got[k]), _bits(want)), k
    got[next(iter(got))].add_(1)      # the mapping is private: views are writable


def test_writer_loads_in_safetensors_package(tmp_path):
    tensors = _sample_tensors(1)
    g = torch.Generator().manual_seed(3)
    base = torch.randn(6, 8, generator=g).to(torch.bfloat16)
    tensors["transposed_view"] = base.T          # non-contiguous
    tensors["row_block"] = base[2:4]             # a view with an offset
    path = str(tmp_path / "b.safetensors")
    nbytes = save_file(tensors, path, metadata={"k": "v"})
    assert nbytes == os.path.getsize(path)
    with open(path, "rb") as f:
        header_len = int.from_bytes(f.read(8), "little")
    assert header_len % 8 == 0
    with safe_open(path, framework="pt") as f:
        assert set(f.keys()) == set(tensors)
        assert f.metadata() == {"k": "v"}
        for k, want in tensors.items():
            got = f.get_tensor(k)
            assert got.dtype == want.dtype and got.shape == want.shape, k
            assert torch.equal(_bits(got), _bits(want)), k
    # the dtype cast as written: tensors of one dim or more only
    save_file({"w": base.float(), "alpha": torch.tensor(4.0)}, path, dtype=torch.bfloat16)
    back = TP.load_safetensors_dir(path)
    assert back["w"].dtype == torch.bfloat16 and back["alpha"].dtype == torch.float32
    assert torch.equal(back["w"], base)


def test_directory_of_shards_loads_as_one_dict(tmp_path):
    rng = np.random.default_rng(0)
    a = {"x.weight": rng.standard_normal((4, 3)).astype(np.float32)}
    b = {"y.weight": rng.standard_normal((2, 5)).astype(np.float32),
         "y.bias": rng.standard_normal(2).astype(np.float32)}
    st_save_file(_torch_sd(a), str(tmp_path / "m-00001-of-00002.safetensors"))
    save_file(_torch_sd(b), str(tmp_path / "m-00002-of-00002.safetensors"))
    (tmp_path / "config.json").write_text("{}")
    ours = TP.load_safetensors_dir(str(tmp_path))
    ref = JPa.load_safetensors_dir(str(tmp_path))
    assert set(ours) == set(ref) == {"x.weight", "y.weight", "y.bias"}
    for k in ref:
        np.testing.assert_array_equal(n(ours[k]), ref[k])
    single = TP.load_safetensors_dir(str(tmp_path / "m-00001-of-00002.safetensors"))
    assert set(single) == {"x.weight"}
    with pytest.raises(FileNotFoundError):
        TP.load_safetensors_dir(str(tmp_path / "nothing"))


# ---------------------------------------------------------------------------
# converters
# ---------------------------------------------------------------------------

def test_flux_loader_matches_jax_converter(tmp_path, rng):
    params = JT.init_flux_params(jax.random.PRNGKey(0), FLUX_TINY)
    JE.save_transformer_checkpoint(params, FLUX_TINY, str(tmp_path))
    cfg = port_cfg(FLUX_TINY)
    ours = TP.load_flux_transformer(str(tmp_path), cfg, dtype=torch.float32, device="cpu")
    ref_tree = JPa.convert_flux_state_dict(JPa.load_safetensors_dir(str(tmp_path)), FLUX_TINY)
    ref = port_module(ref_tree, FLUX_TINY)
    assert ours.rope_layout == "interleaved"
    assert_modules_equal(ours, ref)

    ids = np.concatenate([JP.text_ids(5), JP.latent_image_ids(4, 6)], 0)
    t_img = len(ids) - 5
    args = (rng.standard_normal((1, t_img, FLUX_TINY.in_channels)).astype(np.float32),
            rng.standard_normal((1, 5, FLUX_TINY.joint_dim)).astype(np.float32),
            rng.standard_normal((1, FLUX_TINY.pooled_dim)).astype(np.float32),
            np.array([0.6], np.float32), np.array([30.0], np.float32),
            *JR.rope_tables(ids, FLUX_TINY.axes_dims_rope))
    want = JT.flux_apply(jax.tree.map(jnp.asarray, ref_tree), FLUX_TINY,
                         *map(jnp.asarray, args), attn_impl="xla")
    with torch.no_grad():
        got = TT.flux_apply(ours, *map(t, args), attn_impl="plain")
    np.testing.assert_allclose(n(got), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_flux_loader_consumes_every_real_key(real_depth_params):
    sd = JE.export_flux_state_dict(real_depth_params, FLUX_REAL_DEPTH)
    assert set(sd) == set(MANIFEST["transformer"])
    model = TP.convert_flux_state_dict(_torch_sd(sd), port_cfg(FLUX_REAL_DEPTH),
                                       device="cpu", dtype=torch.float32)
    assert len(TP.flux_key_map(model)) == len(MANIFEST["transformer"])
    ref = port_module(JPa.convert_flux_state_dict(sd, FLUX_REAL_DEPTH), FLUX_REAL_DEPTH)
    assert_modules_equal(model, ref)


@pytest.mark.parametrize("component", ["vae", "clip", "t5"])
def test_converters_match_jax_on_real_keys(component):
    """State dicts with every key of the real checkpoint (tiny dims, real
    layer counts): the port's converter fills its module bitwise as the JAX
    converter + load_jax_params do, and reads every key (the loader raises
    on one it leaves, and T5's embed_tokens is the tied alias of shared)."""
    sd = manifest_state_dict(component)
    cfg = TINY_CFGS[component]
    ours = TP.convert_state_dict(_torch_sd(sd), port_cfg(cfg), device="cpu",
                                 dtype=torch.float32)
    ref = port_module(JAX_CONVERT[component](sd, cfg), cfg)
    assert_modules_equal(ours, ref)
    unread = set(MANIFEST[component]) - set(TP.key_map(ours))
    assert unread == ({"encoder.embed_tokens.weight"} if component == "t5" else set())


def test_t5_embedding_alias_used_when_shared_is_absent():
    sd = manifest_state_dict("t5")
    want = sd["shared.weight"].copy()
    sd["encoder.embed_tokens.weight"] = want
    del sd["shared.weight"]
    model = TP.convert_t5_state_dict(_torch_sd(sd), port_cfg(T5_REAL_DEPTH), device="cpu",
                                     dtype=torch.float32)
    np.testing.assert_array_equal(n(model.embedding), want)


def test_loader_fails_loudly_on_missing_and_unexpected_keys():
    sd = _torch_sd(manifest_state_dict("clip"))
    cfg = port_cfg(CLIP_REAL_DEPTH)
    missing = dict(sd)
    del missing["text_model.encoder.layers.3.mlp.fc2.bias"]
    with pytest.raises(KeyError, match="1 missing"):
        TP.convert_clip_state_dict(missing, cfg, device="cpu")
    extra = dict(sd, **{"text_model.encoder.layers.12.mlp.fc2.bias": torch.zeros(16)})
    with pytest.raises(KeyError, match="1 unexpected"):
        TP.convert_clip_state_dict(extra, cfg, device="cpu")
    wrong = dict(sd, **{"text_model.final_layer_norm.weight": torch.ones(17)})
    with pytest.raises(ValueError, match="shape"):
        TP.convert_clip_state_dict(wrong, cfg, device="cpu")


def test_loader_dtypes_and_no_random_init(tmp_path):
    """bf16 weights with float32 norm scales, as to_device_params casts."""
    params = JT.init_flux_params(jax.random.PRNGKey(0), FLUX_TINY)
    JE.save_transformer_checkpoint(params, FLUX_TINY, str(tmp_path))
    model = TP.load_flux_transformer(str(tmp_path), port_cfg(FLUX_TINY), device="cpu")
    for name, p in model.named_parameters():
        want = torch.float32 if name.endswith("scale") else torch.bfloat16
        assert p.dtype == want, name
    ref = JPa.to_device_params(JPa.convert_flux_state_dict(
        JPa.load_safetensors_dir(str(tmp_path)), FLUX_TINY))
    np.testing.assert_array_equal(
        n(model.double_blocks[1].img_qkv.weight.float()),
        np.asarray(ref["double"]["img_qkv"]["w"][1].astype(jnp.float32)).T)


@pytest.mark.parametrize("key,value", [("guidance_embeds", False), ("num_layers", 3),
                                       ("attention_head_dim", 16)])
def test_flux_config_mismatch_raises(tmp_path, key, value):
    params = JT.init_flux_params(jax.random.PRNGKey(0), FLUX_TINY)
    JE.save_transformer_checkpoint(params, FLUX_TINY, str(tmp_path))
    cfg_path = tmp_path / "config.json"
    cfg = json.loads(cfg_path.read_text())
    cfg[key] = value
    cfg_path.write_text(json.dumps(cfg))
    with pytest.raises(ValueError, match=key):
        TP.load_flux_transformer(str(tmp_path), port_cfg(FLUX_TINY), device="cpu")
    with pytest.raises(ValueError, match=key):
        JPa.load_flux_transformer(str(tmp_path), FLUX_TINY)


def test_config_io_matches_jax(tmp_path):
    from textflux_tpu.io import config_io as JC
    from textflux_torch.io import config_io as TC

    (tmp_path / "config.json").write_text(json.dumps(
        {"in_channels": 48, "num_layers": 2, "guidance_embeds": False, "shift_factor": None,
         "block_out_channels": [8, 16], "hidden_size": 16, "d_model": 32}))
    for name in ("flux_config_from", "vae_config_from", "clip_config_from", "t5_config_from"):
        for path in (str(tmp_path), str(tmp_path / "absent")):
            assert getattr(TC, name)(path) == port_cfg(getattr(JC, name)(path)), name


# ---------------------------------------------------------------------------
# LoRA fold
# ---------------------------------------------------------------------------

LORA_MODULES = ["transformer_blocks.0.attn.to_q", "transformer_blocks.0.attn.to_v",
                "transformer_blocks.1.attn.add_k_proj", "transformer_blocks.1.ff.net.2",
                "transformer_blocks.0.ff_context.net.0.proj",
                "single_transformer_blocks.1.attn.to_k",
                "single_transformer_blocks.0.proj_mlp", "single_transformer_blocks.1.proj_out"]


def _lora_sd(base_sd, *, rank=3, with_alpha=True, seed=1):
    rng = np.random.default_rng(seed)
    out = {}
    for mod in LORA_MODULES:
        w = base_sd[f"{mod}.weight"]
        out[f"transformer.{mod}.lora_A.weight"] = (
            rng.standard_normal((rank, w.shape[1])).astype(np.float32) * 0.3)
        out[f"transformer.{mod}.lora_B.weight"] = (
            rng.standard_normal((w.shape[0], rank)).astype(np.float32) * 0.3)
        if with_alpha:
            out[f"transformer.{mod}.alpha"] = np.float32(rng.uniform(1, 8))
    return out


@pytest.mark.parametrize("with_alpha", [True, False], ids=["alpha", "no_alpha"])
def test_lora_fold_matches_jax(tmp_path, with_alpha):
    params, base_sd = jax_flux_sd(FLUX_TINY)
    lora_sd = _lora_sd(base_sd, with_alpha=with_alpha)
    JE.save_transformer_checkpoint(params, FLUX_TINY, str(tmp_path / "transformer"))
    (tmp_path / "lora").mkdir()
    save_file(_torch_sd(lora_sd), str(tmp_path / "lora" / "pytorch_lora_weights.safetensors"))
    ref_sd = JL.fold_lora_into_state_dict(base_sd, lora_sd, scale=0.7)
    ref = port_module(JPa.convert_flux_state_dict(ref_sd, FLUX_TINY), FLUX_TINY)
    # the directory resolves to its pytorch_lora_weights.safetensors
    ours = TL.load_folded_flux_transformer(str(tmp_path / "transformer"), str(tmp_path / "lora"),
                                           port_cfg(FLUX_TINY), scale=0.7, dtype=torch.float32,
                                           device="cpu")
    pa, pb = dict(ours.named_parameters()), dict(ref.named_parameters())
    for k in pa:
        np.testing.assert_allclose(n(pa[k]), n(pb[k]), atol=1e-6, rtol=0, err_msg=k)
    moved = ours.double_blocks[0].img_qkv.weight[:FLUX_TINY.hidden_dim] - t(
        base_sd["transformer_blocks.0.attn.to_q.weight"])
    assert moved.abs().max() > 1e-3        # the fold landed in to_q's row block
    folded = TL.fold_lora_into_state_dict(_torch_sd(base_sd), _torch_sd(lora_sd), scale=0.7)
    for k, v in ref_sd.items():
        np.testing.assert_allclose(n(folded[k]), v, atol=1e-6, rtol=0, err_msg=k)


def test_lora_errors_match_jax(tmp_path):
    params, base_sd = jax_flux_sd(FLUX_TINY)
    kohya = {"lora_unet_double_blocks_0_img_attn_qkv.lora_down.weight": np.zeros((2, 4), np.float32)}
    with pytest.raises(ValueError, match="unrecognized naming scheme"):
        JL.fold_lora_into_state_dict(base_sd, kohya)
    with pytest.raises(ValueError, match="unrecognized naming scheme"):
        TL.fold_lora_into_state_dict(_torch_sd(base_sd), _torch_sd(kohya))
    stray = {"transformer.transformer_blocks.9.attn.to_q.lora_A.weight": np.zeros((2, 16), np.float32),
             "transformer.transformer_blocks.9.attn.to_q.lora_B.weight": np.zeros((16, 2), np.float32)}
    with pytest.raises(KeyError, match="missing base weight"):
        JL.fold_lora_into_state_dict(base_sd, stray)
    with pytest.raises(KeyError, match="missing base weight"):
        TL.fold_lora_into_state_dict(_torch_sd(base_sd), _torch_sd(stray))
    JE.save_transformer_checkpoint(params, FLUX_TINY, str(tmp_path / "t"))
    save_file(_torch_sd(stray), str(tmp_path / "stray.safetensors"))
    with pytest.raises(KeyError, match="missing base weight"):
        TL.load_folded_flux_transformer(str(tmp_path / "t"), str(tmp_path / "stray.safetensors"),
                                        port_cfg(FLUX_TINY), device="cpu")


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------

def test_flux_export_matches_jax():
    params = JT.init_flux_params(jax.random.PRNGKey(5), FLUX_TINY)
    ref = JE.export_flux_state_dict(params, FLUX_TINY)
    model = port_module(params, FLUX_TINY)
    ours = TE.export_flux_state_dict(model)
    assert set(ours) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(n(ours[k]), np.asarray(v, np.float32), err_msg=k)
    TT.half_permute_flux_params(model)
    with pytest.raises(ValueError, match="interleaved"):
        TE.export_flux_state_dict(model)


@pytest.mark.parametrize("rank_arg", [None, 4], ids=["rank_none", "rank_4"])
def test_lora_export_matches_jax(rank_arg, real_depth_params):
    params = real_depth_params
    tree = jax_lora_init(jax.random.PRNGKey(7), params, FLUX_REAL_DEPTH, rank=4)
    rng = np.random.default_rng(0)
    tree = jax.tree.map(lambda x: np.asarray(x) + rng.standard_normal(x.shape).astype(np.float32),
                        tree)
    ref = JE.export_lora_state_dict(tree, FLUX_REAL_DEPTH, alpha=8.0, rank=rank_arg)
    model = port_module(params, FLUX_REAL_DEPTH)
    ours = TE.export_lora_state_dict(load_jax_lora(tree, model), port_cfg(FLUX_REAL_DEPTH),
                                     alpha=8.0, rank=rank_arg)
    assert set(ours) == set(ref)
    assert {k for k in ours if not k.endswith(".alpha")} == set(MANIFEST["lora"])
    for k, v in ref.items():
        got = n(ours[k])
        assert got.shape == np.shape(v) and got.dtype == np.float32, k
        np.testing.assert_array_equal(got, np.asarray(v), err_msg=k)


def test_export_load_round_trip(tmp_path, rng):
    """Port model -> 3 shards + index -> port loader: the same parameters
    and the same flux_apply; the shards also load in the JAX loader."""
    params = JT.init_flux_params(jax.random.PRNGKey(8), FLUX_TINY)
    model = port_module(params, FLUX_TINY)
    out = str(tmp_path / "transformer")
    TE.save_transformer_checkpoint(model, out, shards=3)
    names = sorted(os.listdir(out))
    assert names == ["config.json", "diffusion_pytorch_model-00001-of-00003.safetensors",
                     "diffusion_pytorch_model-00002-of-00003.safetensors",
                     "diffusion_pytorch_model-00003-of-00003.safetensors",
                     "diffusion_pytorch_model.safetensors.index.json"]
    index = json.loads(open(os.path.join(out, names[-1])).read())
    assert set(index["weight_map"]) == set(TE.export_flux_state_dict(model))
    back = TP.load_flux_transformer(out, model.cfg, dtype=torch.float32, device="cpu")
    assert_modules_equal(back, model)
    ids = np.concatenate([JP.text_ids(3), JP.latent_image_ids(4, 8)], 0)   # 3 + 8 tokens
    args = (t(rng.standard_normal((1, 8, FLUX_TINY.in_channels))),
            t(rng.standard_normal((1, 3, FLUX_TINY.joint_dim))),
            t(rng.standard_normal((1, FLUX_TINY.pooled_dim))), t([0.5]), t([30.0]),
            *map(t, JR.rope_tables(ids, FLUX_TINY.axes_dims_rope)))
    with torch.no_grad():
        assert torch.equal(TT.flux_apply(back, *args), TT.flux_apply(model, *args))
    ref = JPa.convert_flux_state_dict(JPa.load_safetensors_dir(out), FLUX_TINY)
    assert_modules_equal(port_module(ref, FLUX_TINY), model)
