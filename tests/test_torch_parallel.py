"""The port's multi-device serving (textflux_torch/parallel/partitioning.py,
the tp > 1 paths of models/transformer.py, the sharded load, the mesh paths
of FillPipeline, run_eval --mesh and the demo on a mesh) held against the
JAX package and against the port's single-rank runs, on the CPU.

Single-process cases: the specs of every linear, tp_permute_flux_params
against JAX's, its errors, adapt_specs_to_params against JAX's per
quantised layout and LoRA-carrying linears, the half-split NF4 shard rule,
and the sharded checkpoint load against permuting and slicing the whole
module (bitwise).

Multi-rank cases run in spawned ranks over gloo (tests/torch_dist_helpers.py,
one thread each; every join has a timeout and every rank is killed at the
end). The JAX side runs here in the parent on its 8-device CPU mesh, and
results cross as numpy through pickle files. Tolerances (float32
throughout): flux_apply within 2e-5 of JAX's sharded and unsharded forward
(JAX's own sharded-vs-unsharded bound, tests/test_sharding.py);
generate_batch's float images within 1e-4 of JAX's sharded generate_batch
(the port-vs-JAX bound of tests/test_torch_serving.py); the quantised
shards and from_pretrained(mesh=) within 1e-4 of the unsharded port
(the same weights bit for bit, sums in another order); images saved by
run_eval and the demo callbacks within 1 grey level of the single-rank
run.
"""

import json
import os
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from tests.helpers import FLUX_TINY, VAE_TINY, tiny_pipeline
from textflux_tpu.config import FluxConfig
from textflux_tpu.io.export import save_transformer_checkpoint
from textflux_tpu.io.quantize import quantize_tree as jax_quantize_tree
from textflux_tpu.models import transformer as JT
from textflux_tpu.ops import packing as JP, rope as JR
from textflux_tpu.parallel import partitioning as JPT
from textflux_tpu.pipeline import fill as JF

import textflux_torch.config as TC
from textflux_torch.cli import demo as TD, run_eval as TR
from textflux_torch.io import params as TP
from textflux_torch.io.lora import fold_transform, lora_deltas
from textflux_torch.io.quantize import QuantLinear, quantize_plan, quantize_tree
from textflux_torch.io.safetensors import save_file
from textflux_torch.models import transformer as TT
from textflux_torch.parallel import partitioning as PT
from textflux_torch.pipeline.fill import FillPipeline

import torch_dist_helpers as D
from torch_port_helpers import jax_pipeline_noise, port_cfg, port_module, write_tiny_checkpoint

# four heads: tp 2 and 4 (tests/test_sharding.py's config)
FLUX_HEADS4 = FluxConfig(
    in_channels=48, out_channels=16, num_double_layers=2, num_single_layers=2,
    num_heads=4, head_dim=8, joint_dim=32, pooled_dim=16, guidance_embeds=True,
    axes_dims_rope=(4, 2, 2), time_embed_channels=256)
# hidden 256: every row-parallel input (256, 1024, 1280) splits over tp 2
# into multiples of 128, so NF4 shards are NF4 on both ranks
FLUX_WIDE = FluxConfig(
    in_channels=48, out_channels=16, num_double_layers=1, num_single_layers=1,
    num_heads=2, head_dim=128, joint_dim=32, pooled_dim=16, guidance_embeds=True,
    axes_dims_rope=(32, 48, 48), time_embed_channels=256)
STEPS = 2
H, W = 32, 48
FLUX_TOL = 2e-5
IMAGE_TOL = 1e-4


def _fake_mesh(tp, rank):
    return types.SimpleNamespace(tensor=tp, tensor_rank=rank)


def _state(model):
    return {k: v.detach().clone() for k, v in
            list(model.named_parameters()) + list(model.named_buffers())}


def _assert_same_state(a, b):
    sa, sb = _state(a), _state(b)
    assert sa.keys() == sb.keys()
    for k in sa:
        assert sa[k].dtype == sb[k].dtype and torch.equal(sa[k], sb[k]), k


# ---------------------------------------------------------------------------
# specs, permutation, adapted specs
# ---------------------------------------------------------------------------

def _jax_kind(jax_specs, path):
    """COLUMN / ROW / REPLICATED of a port module path under the JAX specs
    (weights (..., in, out): "tensor" on the out axis is column-parallel)."""
    parts = path.split(".")
    if parts[0] in ("double_blocks", "single_blocks"):
        parts = [parts[0].split("_")[0]] + parts[2:]
    node = jax_specs
    for p in parts:
        node = node[p]
    w = tuple(node["w"])
    if w and w[-1] == "tensor":
        return PT.COLUMN
    if len(w) >= 2 and w[-2] == "tensor":
        return PT.ROW
    return PT.REPLICATED


@pytest.mark.parametrize("cfg", [FLUX_TINY, FLUX_HEADS4, FLUX_WIDE],
                         ids=["tiny", "heads4", "wide"])
def test_specs_name_every_linear_as_jax(cfg):
    model = TT.FluxTransformer(port_cfg(cfg), device="meta")
    linears = {n for n, m in model.named_modules() if isinstance(m, torch.nn.Linear)}
    specs = PT.flux_param_specs(port_cfg(cfg))
    assert set(specs) == linears
    jax_specs = JPT.flux_param_specs(cfg)
    assert {p: _jax_kind(jax_specs, p) for p in specs} == specs
    assert sum(k == PT.ROW for k in specs.values()) == (
        4 * cfg.num_double_layers + cfg.num_single_layers)


@pytest.mark.parametrize("fused", [False, True], ids=["interleaved", "half"])
@pytest.mark.parametrize("tp", [2, 4])
def test_tp_permute_matches_jax(tp, fused):
    params = JT.init_flux_params(jax.random.PRNGKey(1), FLUX_HEADS4)
    model = port_module(params, FLUX_HEADS4)
    if fused:
        params = JT.half_permute_flux_params(params, FLUX_HEADS4)
        TT.half_permute_flux_params(model)
    ref = JT.tp_permute_flux_params(params, FLUX_HEADS4, tp)
    assert int(ref.pop("_tp_layout")) == tp
    TT.tp_permute_flux_params(model, tp)
    assert model.tp_layout == tp and model.tp_rank is None
    expect = port_module(ref, FLUX_HEADS4)
    for (name, a), (_, b) in zip(model.named_parameters(), expect.named_parameters()):
        assert torch.equal(a, b), name


def test_tp_permute_and_forward_errors():
    cfg = port_cfg(FLUX_HEADS4)
    model = TT.FluxTransformer(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    x = (torch.zeros(1, 4, cfg.in_channels), torch.zeros(1, 4, cfg.joint_dim),
         torch.zeros(1, cfg.pooled_dim), torch.tensor([0.5]), torch.tensor([4.0]),
         torch.zeros(8, cfg.head_dim), torch.zeros(8, cfg.head_dim))
    # a forward at tp > 1 on naturally ordered weights would scramble q/k/v silently
    with pytest.raises(ValueError, match="tp_permute_flux_params"):
        TT.flux_apply(model, *x, mesh=_fake_mesh(2, 0))
    with pytest.raises(ValueError, match="divisible by tp=3"):
        TT.tp_permute_flux_params(model, 3)
    TT.tp_permute_flux_params(model, 2)
    with pytest.raises(ValueError, match="already tp-permuted"):
        TT.tp_permute_flux_params(model, 4)
    with pytest.raises(ValueError, match="pass the mesh"):
        TT.flux_apply(model, *x)
    with pytest.raises(ValueError, match="device-major"):
        TT.half_permute_flux_params(model)
    with pytest.raises(ValueError, match="tp_permute_flux_params"):
        TT.flux_apply(model, *x, mesh=_fake_mesh(2, 0))   # permuted but not sharded
    # NF4 packs linear2's input rows: permute first, then quantise
    wide = quantize_tree(TT.FluxTransformer(port_cfg(FLUX_WIDE), device="meta"), mode="nf4",
                         min_size=0)
    assert wide.single_blocks[0].linear2.mode == "nf4"
    with pytest.raises(ValueError, match="NF4-packed linear2"):
        TT.tp_permute_flux_params(wide, 2)


def _jax_axis(spec, leaf):
    """The port's split axis of a JAX leaf spec (..., in, out) (port tensors
    are (out, in)): 0 for the out axis, 1 for the in axis, None whole."""
    spec = tuple(spec)
    if leaf in ("b", "scale", "amax_lo", "amax_hi"):
        return 0 if spec and spec[-1] == "tensor" else None
    if spec and spec[-1] == "tensor":
        return 0
    if len(spec) >= 2 and spec[-2] == "tensor":
        return 1
    return None


@pytest.mark.parametrize("mode", ["weight_only", "w8a8", "nf4"])
def test_adapt_specs_matches_jax_per_layout(mode):
    params = JT.init_flux_params(jax.random.PRNGKey(2), FLUX_WIDE)
    # the tree's layout is all the JAX specs read: trace it, compile nothing
    jq = jax.eval_shape(lambda p: jax_quantize_tree(p, mode=mode, min_size=0), params)
    jspecs = JPT.adapt_specs_to_params(JPT.flux_param_specs(FLUX_WIDE), jq)
    model = quantize_tree(port_module(params, FLUX_WIDE), mode=mode, min_size=0)
    specs = PT.adapt_specs_to_params(PT.flux_param_specs(model.cfg), model)
    named = dict(list(model.named_parameters()) + list(model.named_buffers()))
    assert set(specs) == set(named)
    checked = 0
    for name, axis in specs.items():
        parts = name.split(".")
        if parts[0] in ("double_blocks", "single_blocks"):
            node = jspecs[parts[0].split("_")[0]]
            parts = parts[2:]
        else:
            node = jspecs
        for p in parts[:-1]:
            node = node[p]
        leaf = {"weight": "w", "bias": "b"}.get(parts[-1], parts[-1])
        if not isinstance(node, dict):      # the q/k norm scales
            assert axis is None and tuple(node) in ((), (None,)), name
            continue
        want = _jax_axis(node[leaf], leaf)
        # JAX shards NF4 codes on the packed input axis; the port quantises
        # the rank's slice anew (a half-split byte holds two apart rows)
        assert (1 if axis == PT.REQUANTIZE else axis) == want, name
        checked += 1
    assert checked > 40
    assert specs["single_blocks.0.linear2.w_nf4" if mode == "nf4"
                 else "single_blocks.0.linear2.scale"] == (
        PT.REQUANTIZE if mode == "nf4" else None)
    assert specs["double_blocks.0.img_proj.bias"] is None
    assert specs["double_blocks.0.img_qkv.bias"] == 0


def test_adapt_specs_lora_carrying_linears():
    from textflux_torch.training.train import lora_init, lora_insert

    model = TT.FluxTransformer(port_cfg(FLUX_HEADS4), device="cpu",
                               generator=torch.Generator().manual_seed(0))
    lora_insert(model, lora_init(model, 2, generator=torch.Generator().manual_seed(1)), 1.0)
    specs = PT.adapt_specs_to_params(PT.flux_param_specs(model.cfg), model)
    assert specs["double_blocks.0.img_qkv.lora_ga"] is None        # grouped q/k/v
    assert specs["double_blocks.0.img_proj.lora_a"] is None        # single-module
    assert specs["double_blocks.0.img_proj.weight"] == 1
    # replicated factors over a sharded base: the factors stay whole, the
    # linears record the share a rank's forward takes of them
    factors = {n: p.detach().clone() for n, p in model.named_parameters() if ".lora_" in n}
    TT.tp_permute_flux_params(model, 2)
    PT.shard_module(model, PT.flux_param_specs(model.cfg), _fake_mesh(2, 0))
    for n, p in model.named_parameters():
        if n in factors:
            assert torch.equal(p, factors[n]), n
    assert model.double_blocks[0].img_proj.tp_share.kind == PT.ROW
    assert model.double_blocks[0].img_qkv.tp_share.kind == PT.COLUMN


@pytest.mark.parametrize("mode", ["weight_only", "w8a8", "nf4"])
def test_row_parallel_shards_are_the_whole_weights_columns(mode):
    """The shard rule of a row-parallel quantised linear: int8 codes are the
    whole weight's, at the rank's columns, with the scale of the whole row;
    NF4 codes (a half split: byte r holds input rows r and r + in/2) are
    quantised from the rank's slice, and dequantise to the whole weight's
    values at its columns, bitwise."""
    g = torch.Generator().manual_seed(3)
    lin = torch.nn.Linear(512, 64)
    with torch.no_grad():
        lin.weight.copy_(torch.randn(64, 512, generator=g))
    whole = QuantLinear.from_linear(lin, mode)
    assert whole.mode == mode
    for rank in range(2):
        holder = torch.nn.Module()
        holder.proj = torch.nn.Linear(512, 64)
        holder.proj.load_state_dict(lin.state_dict())
        PT.shard_linears(holder, {"proj": PT.ROW}, 2, rank, {"proj": mode})
        shard = holder.proj
        assert isinstance(shard, QuantLinear) and shard.mode == mode
        assert shard.in_features == 256 and torch.equal(shard.bias, whole.bias)
        cols = slice(256 * rank, 256 * (rank + 1))
        assert torch.equal(shard.dequantize(torch.float32),
                           whole.dequantize(torch.float32)[:, cols])
        if mode != "nf4":
            codes = "w_q8a8" if mode == "w8a8" else "w_q"
            assert torch.equal(getattr(shard, codes), getattr(whole, codes)[:, cols])
            assert torch.equal(shard.scale, whole.scale)
    if mode == "nf4":
        # a contiguous slice of the packed bytes is not the rank's columns
        with pytest.raises(ValueError, match="half split"):
            PT.shard_linears(_holder(whole), {"proj": PT.ROW}, 2, 0)


def _holder(lin):
    holder = torch.nn.Module()
    holder.proj = lin
    return holder


@pytest.fixture(scope="module")
def wide_checkpoint(tmp_path_factory):
    """A transformer checkpoint of FLUX_WIDE (the JAX exporter) and a peft
    LoRA over a column- and a row-parallel module of it."""
    root = tmp_path_factory.mktemp("wide_ckpt")
    params = JT.init_flux_params(jax.random.PRNGKey(4), FLUX_WIDE)
    save_transformer_checkpoint(params, FLUX_WIDE, str(root / "transformer"))
    rng = np.random.default_rng(5)
    lora = {}
    for mod, (d_out, d_in) in {"transformer_blocks.0.attn.to_k": (256, 256),
                               "transformer_blocks.0.ff.net.2": (256, 1024),
                               "single_transformer_blocks.0.proj_out": (256, 1280)}.items():
        lora[f"transformer.{mod}.lora_A.weight"] = torch.tensor(
            rng.standard_normal((2, d_in)) * 0.1, dtype=torch.float32)
        lora[f"transformer.{mod}.lora_B.weight"] = torch.tensor(
            rng.standard_normal((d_out, 2)) * 0.1, dtype=torch.float32)
    save_file(lora, str(root / "lora.safetensors"))
    return str(root)


@pytest.mark.parametrize("mode", [None, "weight_only", "w8a8", "nf4", "lora"])
def test_sharded_load_is_permute_then_shard(wide_checkpoint, mode):
    """load_flux_shard (each checkpoint tensor read at the shard's rows or
    columns, permuted on the way in, quantised as it lands) gives bitwise
    the module that loading the whole DiT, tp_permute_flux_params and
    shard_module give, on every rank; with a LoRA folded into each whole
    tensor before the slice."""
    cfg = port_cfg(FLUX_WIDE)
    path = os.path.join(wide_checkpoint, "transformer")
    quantize = None if mode in (None, "lora") else mode
    transform = None
    if mode == "lora":
        transform = fold_transform(lora_deltas(TP.load_safetensors_dir(
            os.path.join(wide_checkpoint, "lora.safetensors")), scale=0.7), "cpu")
    for rank in range(2):
        shard = TP.load_flux_shard(path, cfg, tp=2, rank=rank, device="cpu",
                                   dtype=torch.float32, transform=transform,
                                   quantize=quantize, min_size=0)
        whole = TP.load_flux_transformer(path, cfg, device="cpu", dtype=torch.float32,
                                         transform=transform)
        TT.tp_permute_flux_params(whole, 2)
        PT.shard_module(whole, PT.flux_param_specs(cfg), _fake_mesh(2, rank),
                        quantize=quantize, min_size=0)
        assert (shard.tp_layout, shard.tp_rank) == (whole.tp_layout, whole.tp_rank) == (2, rank)
        _assert_same_state(shard, whole)
        if quantize:
            assert set(quantize_plan(TT.FluxTransformer(cfg, device="meta"), mode=quantize,
                                     min_size=0)) == {
                n for n, m in shard.named_modules() if isinstance(m, QuantLinear)}


def test_serving_mesh_shape_and_the_process_group(monkeypatch):
    assert PT.serving_mesh_shape("2,1,2") == (2, 1, 2)
    assert PT.serving_mesh_shape("1,2,1") == (1, 2, 1)   # the DiT storage-sharded over fsdp
    for bad in ("2,2", "a,1,1", "0,1,1"):
        with pytest.raises(ValueError, match="dp,fsdp,tp"):
            PT.serving_mesh_shape(bad)
    for name in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        PT.make_mesh((1, 1, 1), device="cpu")


# ---------------------------------------------------------------------------
# multi-rank cases
# ---------------------------------------------------------------------------

def _trees(pipe):
    return {k: (jax.tree.map(np.asarray, getattr(pipe, f"{k}_params")),
                port_cfg(getattr(pipe, f"{k}_cfg"))) for k in ("flux", "vae", "clip", "t5")}


def _pipe_spec(jax_pipe, **kw):
    return dict(modules=_trees(jax_pipe),
                pipe_cfg=TC.PipelineConfig(num_inference_steps=STEPS), **kw)


def _batch_inputs(n, seed=0):
    rng = np.random.default_rng(seed)
    images = [Image.fromarray(rng.integers(0, 255, (H, W, 3), np.uint8)) for _ in range(n)]
    masks = []
    for i in range(n):
        m = np.zeros((H, W), np.uint8)
        m[8:20 + i, 10:30] = 255
        masks.append(Image.fromarray(m))
    return images, masks


def _flux_inputs():
    rng = np.random.default_rng(0)
    ids = np.concatenate([JP.text_ids(4), JP.latent_image_ids(8, 8)], 0)
    return dict(ids=ids, img=rng.standard_normal((2, 16, 48)).astype(np.float32),
                txt=rng.standard_normal((2, 4, 32)).astype(np.float32),
                pooled=rng.standard_normal((2, 16)).astype(np.float32),
                timestep=np.array([0.5, 0.9], np.float32),
                guidance=np.array([4.0, 4.0], np.float32))


def _jax_flux_refs(params, x, tp):
    """JAX's unsharded flux_apply, and its tensor-parallel one on (1, 1, tp).
    The port's fused path is held to the unsharded one too: the half
    permutation is a similarity transform of the logits."""
    args = [jnp.asarray(x[k]) for k in ("img", "txt", "pooled", "timestep", "guidance")]
    cos, sin = (jnp.asarray(t) for t in JR.rope_tables(x["ids"], FLUX_HEADS4.axes_dims_rope))
    out = {"plain": np.asarray(JT.flux_apply(params, FLUX_HEADS4, *args, cos, sin,
                                             attn_impl="xla"))}
    mesh = JPT.make_mesh((1, 1, tp), jax.devices()[:tp])
    permuted = JT.tp_permute_flux_params(params, FLUX_HEADS4, tp)
    sharded = JPT.shard_tree(permuted, JPT.adapt_specs_to_params(
        JPT.flux_param_specs(FLUX_HEADS4), permuted), mesh)
    with mesh:
        out["sharded"] = np.asarray(jax.jit(lambda p, *a: JT.flux_apply(
            p, FLUX_HEADS4, *a, attn_impl="xla", tp=tp, mesh=mesh))(sharded, *args, cos, sin))
    out["fused"] = out["plain"]
    return out


@pytest.fixture(scope="module")
def four_ranks():
    """World 4: flux_apply at (1, 1, 4) and generate_batch at (2, 1, 2),
    with their JAX references."""
    params = JT.init_flux_params(jax.random.PRNGKey(7), FLUX_HEADS4)
    x = _flux_inputs()
    jax_pipe = tiny_pipeline(steps=STEPS)
    images, masks = _batch_inputs(3)
    words = [["w1"], ["w2"], ["w3"]]
    seeds = [3, 5, 11]
    noise = [jax_pipeline_noise(s, height=H, width=W, vae_cfg=VAE_TINY, steps=STEPS)
             for s in seeds]
    call = dict(images=images, masks=masks, words_list=words, height=H, width=W,
                num_inference_steps=STEPS, seeds=seeds, sampler="euler", noise=noise)
    with D.Ranks(D.four_rank_cases, 4, dict(
            flux=dict(cfg=port_cfg(FLUX_HEADS4), tree=jax.tree.map(np.asarray, params),
                      inputs=x),
            batch=_pipe_spec(jax_pipe, shape=(2, 1, 2), call=call))) as ranks:
        # the JAX side while the ranks run
        spipe = tiny_pipeline(steps=STEPS)
        mesh = JPT.make_mesh((2, 2, 2))
        spipe.shard_for_serving(mesh)
        with mesh, pytest.MonkeyPatch.context() as mp:
            mp.setattr(JF.improc, "postprocess_image", lambda x: x)
            jax_batch = np.asarray(spipe.generate_batch(
                images, masks, words, height=H, width=W, num_inference_steps=STEPS,
                seeds=seeds, sampler="euler", dtype=jnp.float32))
        flux_ref = _jax_flux_refs(params, x, 4)
        results = ranks.results()
    return dict(results=results, flux_ref=flux_ref, batch_ref=jax_batch)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """World 2: flux_apply at (1, 1, 2), the quantised shards, from_pretrained
    (mesh=), run_eval --mesh and the demo callbacks, with their references."""
    root = tmp_path_factory.mktemp("parallel2")
    params = JT.init_flux_params(jax.random.PRNGKey(7), FLUX_HEADS4)
    x = _flux_inputs()
    jax_pipe = tiny_pipeline(steps=STEPS)
    # the wide pipeline: FLUX_WIDE's DiT beside the tiny VAE and encoders
    wide_trees = _trees(jax_pipe)
    wide_trees["flux"] = (jax.tree.map(np.asarray, JT.init_flux_params(
        jax.random.PRNGKey(8), FLUX_WIDE)), port_cfg(FLUX_WIDE))
    images, masks = _batch_inputs(2, seed=1)
    qcall = dict(images=images, masks=masks, words_list=[["q1"], ["q2"]], height=H, width=W,
                 num_inference_steps=STEPS, seeds=[1, 2], sampler="euler")
    wide = dict(modules=wide_trees, pipe_cfg=TC.PipelineConfig(num_inference_steps=STEPS))
    quant = {mode: dict(wide, shape=(1, 1, 2), call=qcall, quantize=mode, min_size=0)
             for mode in ("weight_only", "w8a8", "nf4")}
    # over the fsdp axis: the DiT storage-sharded, the batch a sample a rank
    quant["fsdp"] = dict(wide, shape=(1, 2, 1), call=qcall)
    quant["weight_only_fsdp"] = dict(wide, shape=(1, 2, 1), call=qcall, quantize="weight_only",
                                     min_size=0)
    ckpt = write_tiny_checkpoint(str(root / "ckpt"))
    pcfg = TC.PipelineConfig(num_inference_steps=STEPS, max_sequence_length=16)
    img, mask = _batch_inputs(1, seed=2)
    pcall = dict(image=img[0], mask_image=mask[0], words=["OPEN"], height=H, width=W, seed=4)
    items = _write_items(root)
    eval_argv = ["--model", ckpt, "--json-path", items["json"], "--original-images-dir",
                 items["imgs"], "--steps", str(STEPS), "--max-sequence-length", "16",
                 "--device", "cpu"]
    runs = {"dp": eval_argv + ["--mesh", "2,1,1", "--batch-size", "2"],
            "tp": eval_argv + ["--mesh", "1,1,2", "--batch-size", "1"],
            "fsdp": eval_argv + ["--mesh", "1,2,1", "--batch-size", "2"]}
    scene = _scene()
    demo = _pipe_spec(jax_pipe, shape=(1, 1, 2),
                      custom_args=({"image": scene[0], "mask": scene[1]}, "hi\nyo", STEPS,
                                   7.0, 2, 1.5),
                      normal_args=(scene[0], scene[2], "word"))
    with D.Ranks(D.two_rank_cases, 2, dict(
            flux=dict(cfg=port_cfg(FLUX_HEADS4), tree=jax.tree.map(np.asarray, params),
                      inputs=x),
            quant=quant,
            pretrained=dict(shape=(1, 1, 2), checkpoint=ckpt, lora=os.path.join(ckpt, "lora"),
                            lora_scale=0.8, pipe_cfg=pcfg, call=pcall),
            pretrained_fsdp=dict(shape=(1, 2, 1), checkpoint=ckpt,
                                 lora=os.path.join(ckpt, "lora"), lora_scale=0.8,
                                 pipe_cfg=pcfg, call=pcall),
            tp_grad=dict(cfg=port_cfg(FLUX_HEADS4), tree=jax.tree.map(np.asarray, params),
                         inputs=x),
            run_eval=dict(root=str(root / "eval"), argv=runs), demo=demo)) as ranks:
        # the single-rank references, on the port
        refs = {"flux": _jax_flux_refs(params, x, 2), "quant": {}, "pretrained": {}}
        for mode in ("weight_only", "w8a8", "nf4", "fsdp"):
            pipe = D.build_pipeline(wide)
            if mode != "fsdp":
                quantize_tree(pipe.flux, mode=mode, min_size=0)
            with D.float_images():
                out = pipe.generate_batch(**qcall, dtype=torch.float32)
            refs["quant"][mode] = np.asarray(out)
        refs["quant"]["weight_only_fsdp"] = refs["quant"]["weight_only"]
        for name, lora in (("base", None), ("lora", os.path.join(ckpt, "lora"))):
            pipe = FillPipeline.from_pretrained(ckpt, lora_path=lora, lora_scale=0.8,
                                                dtype=torch.float32, pipe_cfg=pcfg,
                                                device="cpu")
            refs["pretrained"][name] = pipe(**pcall, dtype=torch.float32, output_type="np")
            refs["pretrained"][name + "_bytes"] = (
                pipe.load_stats["transformer"]["device_bytes"])
        single = str(root / "eval" / "single")
        with D.float32_pipelines():
            for name, argv in runs.items():
                if name == "fsdp":   # the same batches as dp's (a sample a rank)
                    continue
                batch = argv[argv.index("--batch-size"):argv.index("--batch-size") + 2]
                TR.main(eval_argv + batch + ["--output-dir", os.path.join(single, name)])
        ref_pipe = D.build_pipeline(_pipe_spec(jax_pipe))
        callbacks = TD.ui_callbacks(D.Float32(ref_pipe), beta=True)
        refs["demo"] = {"custom": np.asarray(callbacks["custom"](*demo["custom_args"])),
                        "normal": np.asarray(callbacks["normal"](*demo["normal_args"]))}
        results = ranks.results()
    return dict(results=results, refs=refs, root=root, single=single,
                names=items["names"])


def _write_items(root):
    """Three eval items, two in one //32 bucket."""
    rng = np.random.default_rng(0)
    imgs = root / "imgs"
    imgs.mkdir()
    data = {"data_list": []}
    names = []
    for i, ((h, w), text) in enumerate(zip([(96, 128), (96, 128), (64, 96)],
                                           ["OPEN", "SALE", "AB"])):
        name = f"e_{i}.png"
        Image.fromarray(rng.integers(0, 255, (h, w, 3), np.uint8)).save(imgs / name)
        data["data_list"].append({"img_name": name, "annotations": [
            {"text": text, "polygon": [[10, 12], [w - 12, 14], [w - 10, 40], [12, 38]]}]})
        names.append(name)
    with open(root / "items.json", "w") as f:
        json.dump(data, f)
    return dict(json=str(root / "items.json"), imgs=str(imgs), names=names)


def _scene():
    rng = np.random.default_rng(5)
    original = Image.fromarray(rng.integers(0, 255, (64, 96, 3), np.uint8))
    drawn = np.array(original).copy()
    drawn[20:40, 30:70] = 255
    mask = Image.fromarray((drawn[..., 0] == 255).astype(np.uint8) * 255)
    return original, Image.fromarray(drawn), mask


def _ok(result):
    assert not (isinstance(result, dict) and "error" in result), result.get("error")
    return result


def _check_flux(results, refs, tp):
    for rank, res in enumerate(results):
        for impl in ("plain", "fused"):
            r = _ok(_ok(res["flux"])[impl])
            assert r["heads"] == FLUX_HEADS4.num_heads // tp
            # 4 per double block, 1 per single; the embedders and every
            # modulation vector gathered (mods per block, per call here)
            assert r["counts"]["all_reduce_sum"] == 4 * 2 + 2
            assert r["counts"]["all_gather_last"] == 2 + 2 * 2 + 2
            np.testing.assert_allclose(r["out"], refs[impl], atol=FLUX_TOL, err_msg=impl)
            if impl == "plain":
                np.testing.assert_allclose(r["out"], refs["sharded"], atol=FLUX_TOL)


def test_flux_apply_tp4_matches_jax(four_ranks):
    _check_flux(four_ranks["results"], four_ranks["flux_ref"], 4)


def test_flux_apply_tp2_matches_jax(two_ranks):
    _check_flux(two_ranks["results"], two_ranks["refs"]["flux"], 2)


def test_generate_batch_data_and_tensor_parallel_matches_jax(four_ranks):
    """(2, 1, 2), a ragged batch of 3 padded to 4: every rank returns the
    whole batch, JAX's sharded generate_batch on (2, 2, 2) within 1e-4."""
    outs = [_ok(r["batch"]) for r in four_ranks["results"]]
    assert [o["batch_rank"] for o in outs] == [0, 0, 1, 1]
    assert [o["tp_rank"] for o in outs] == [0, 1, 0, 1]
    ref = four_ranks["batch_ref"]
    assert ref.shape == (3, H, W, 3)
    for o in outs:
        assert o["images"].shape == ref.shape
        np.testing.assert_allclose(o["images"], ref, atol=IMAGE_TOL)
        assert o["counts"]["all_gather_batch"] == 1
        # 2 steps x (4 x 2 double + 2 single) all-reduces
        assert o["counts"]["all_reduce_sum"] == STEPS * 10


@pytest.mark.parametrize("mode", ["weight_only", "w8a8", "nf4", "fsdp", "weight_only_fsdp"])
def test_quantized_shards_match_unsharded(two_ranks, mode):
    """Each rank's images within 1e-4 of the unsharded port's: tensor
    shards per quantise mode at (1, 1, 2), and at (1, 2, 1) the DiT
    storage-sharded over fsdp (bf16 weights, and int8 codes), a sample a
    rank, gathered over (data, fsdp): the same weights bit for bit."""
    ref = two_ranks["refs"]["quant"][mode]
    for res in two_ranks["results"]:
        o = _ok(_ok(res["quant"])[mode])
        np.testing.assert_allclose(o["images"], ref, atol=IMAGE_TOL)
        # w8a8: one max over the ranks per row-parallel product
        assert o["counts"]["all_reduce_max"] == (
            o["counts"]["all_reduce_sum"] if mode == "w8a8" else 0)
        if mode.endswith("fsdp"):
            assert o["counts"]["all_reduce_sum"] == 0 and o["counts"]["all_gather_batch"] == 1
            assert o["counts"]["all_gather_storage"] > 0
            assert abs(o["storage_bytes"] / o["whole_bytes"] - 0.5) < 0.01


@pytest.mark.parametrize("case", ["base", "lora", "deferred"])
@pytest.mark.parametrize("axis", ["pretrained", "pretrained_fsdp"])
def test_from_pretrained_mesh_matches_single_rank(two_ranks, case, axis):
    """from_pretrained(mesh=) at (1, 1, 2) (each rank its tensor shard) and
    at (1, 2, 1) (each rank its storage shard over fsdp) against the one
    rank's image, within 1e-4."""
    refs = two_ranks["refs"]["pretrained"]
    shard_bytes = []
    for rank, res in enumerate(two_ranks["results"]):
        o = _ok(_ok(res[axis])[case])
        assert o["tp_rank"] == (rank if axis == "pretrained" else None)
        np.testing.assert_allclose(o["image"], refs["lora" if case == "lora" else "base"],
                                   atol=IMAGE_TOL)
        shard_bytes.append(o["dit_bytes"])
    whole = refs["base_bytes"]
    if axis == "pretrained_fsdp":   # the storage shards hold the DiT once
        assert sum(shard_bytes) == whole and max(shard_bytes) < whole
        return
    # each rank holds less than the whole DiT; together the shards hold
    # it once, and the replicated linears (embedders, output head) once more
    assert max(shard_bytes) < whole < sum(shard_bytes)


@pytest.mark.parametrize("case", ["dp", "tp", "fsdp"])
def test_run_eval_mesh_matches_single_rank(two_ranks, case):
    for res in two_ranks["results"]:
        assert _ok(_ok(res["run_eval"])[case]) is True
    out = two_ranks["root"] / "eval" / case
    assert not (out / "rank1").exists()    # rank 0 alone writes
    with open(out / "rank0" / "failures.json") as f:
        assert json.load(f) == {"total": 3, "done": 3, "failed": 0, "skipped_existing": 0,
                                "failures": []}
    for sub in ("full_images", "cropped_images"):
        for name in two_ranks["names"]:
            a = np.asarray(Image.open(out / "rank0" / sub / name), np.int16)
            b = np.asarray(Image.open(os.path.join(
                two_ranks["single"], "dp" if case == "fsdp" else case, sub, name)), np.int16)
            assert a.shape == b.shape and np.abs(a - b).max() <= 1, (sub, name)


def test_demo_callbacks_on_two_ranks(two_ranks):
    led, follower = (_ok(r["demo"]) for r in two_ranks["results"])
    assert follower == {"followed": 2}
    for name in ("custom", "normal"):
        a = led[name].astype(np.int16)
        b = two_ranks["refs"]["demo"][name].astype(np.int16)
        assert a.shape == b.shape and np.abs(a - b).max() <= 1, name


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("impl", ["plain", "flash"])
def test_flux_apply_tp2_gradients_match_tp1(two_ranks, impl, remat):
    """Training's tensor-parallel forward and backward at (1, 1, 2) (the
    autograd collectives, remat's recompute replaying them) against the
    port's tp = 1 on the same weights: the output within 2e-5 (the sharded
    forward's bound) and every parameter's gradient, gathered and
    un-permuted (a replicated one's rank parts summed), within 1e-5 of its
    largest |value| (measured: 1.4e-6 at most). The forward with no gradient
    (serving) is bitwise the forward that carries one."""
    for res in two_ranks["results"]:
        r = _ok(_ok(res["tp_grad"])[f"{impl}_{remat}"])
        assert r["out_err"] <= FLUX_TOL
        worst = max(r["grad_err"].items(), key=lambda kv: kv[1])
        assert worst[1] <= 1e-5, worst
        assert r["no_grad_bitwise"]
        # forward all-reduces: 4 a double block, 1 a single (twice with
        # remat, whose recompute replays them); the backward's: one a
        # column-parallel product whose input carries a gradient
        assert r["counts"]["all_reduce_sum"] == (2 if remat else 1) * (4 * 2 + 2)
        assert r["counts"]["all_reduce_grad"] > 0
