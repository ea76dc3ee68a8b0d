"""The port's training over the fsdp and tensor axes (parallel/partitioning.py
shard_for_training and the autograd collectives, the sharded optimizers of
training/train.py, the mesh paths of cli/train.py, io/params.py
load_flux_fsdp, io/export.py gathered_flux) held against the JAX package's
train step and against the port's single-device runs, on the CPU.

The ranks are spawned once for the whole file (tests/torch_dist_helpers.py
fsdp_cases: 2 gloo ranks, one thread each, every join under a timeout, every
rank killed at the end); the JAX side runs here meanwhile and the results
cross as numpy. The DiT is FLUX_TINY_WIDE with 1 double and 2 single blocks
(hidden 128), float32 compute, the same global batch of 2 on both sides
with the JAX package's draws for it (each rank takes its row), two steps.
Tolerances are those of the single-device comparisons: full-parameter
modes (tests/test_torch_full_train.py) loss and grad norm within 1e-5
relative, every parameter within 1e-5 of its largest |value|; LoRA
(tests/test_torch_training.py) 1e-4 relative, the factors within 1e-3 of a
step. Given the same gradients, the 8-bit codes and scales are JAX's
bitwise (see its test for the one exception); the global norm is the
single-device port's to 1e-6 relative and Prodigy's D to 1e-5 (see its
test). Checkpoints, resumes and exports are held bitwise.

The tensor-axis cases (mesh (1, 1, 2), "_tp") run in the same spawn against
the same JAX steps: each rank holds its tensor shard of the DiT (one of the
two heads, device-major), the whole batch, and the LoRA factors whole.
They meet the same tolerances.
"""

import dataclasses
import functools
import json
import shutil
import types

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch
from PIL import Image

from helpers import FLUX_TINY_WIDE, VAE_TINY
from textflux_tpu.models import vae as JV
from textflux_tpu.models.transformer import init_flux_params
from textflux_tpu.training import train as JTR

from textflux_torch.cli import train as CLI
from textflux_torch.io.from_jax import load_jax_lora
from textflux_torch.io.export import (export_lora_state_dict, save_safetensors,
                                      save_transformer_checkpoint)
from textflux_torch.io.params import load_flux_transformer
from textflux_torch.models import transformer as TT
from textflux_torch.ops import packing
from textflux_torch.ops.rope import rope_tables, rope_tables_half
from textflux_torch.parallel import partitioning as PT
from textflux_torch.training import train as TR
from textflux_torch.training.checkpoint import CheckpointManager

import torch_dist_helpers as D
from torch_port_helpers import (FLUX_CFG, jax_loss_noise, n, port_cfg, port_module,
                                port_train_config, write_tiny_checkpoint)

FLUX = dataclasses.replace(FLUX_TINY_WIDE, num_single_layers=2)
H = W = 32   # a 16x16 VAE_TINY latent, 64 image tokens
B = 2        # the global batch: one row a rank
# 8-bit AdamW at 5e-6: a gradient summed in another order (two ranks' rows,
# not one batch of two) that lands one log-domain code level away moves its
# element by up to ~5% of lr (tests/test_torch_full_train.py), and 5% of
# 5e-6 is under the smallest tolerance here, 1e-5 of linear2's largest
# |value| 0.0395 (measured at 2e-5: 2 elements of time_in.fc1 8.4e-7 off
# against its 6.25e-7; at 1e-5: 1 element of img_mlp.fc2 4.5e-7 off
# against 4.4e-7)
LEARNING_RATES = {"adamw": 1e-4, "adamw8bit": 5e-6, "prodigy": 1.0, "lora": 1e-3}
ESTIM_LR0 = 1e-4   # Prodigy's starting D on both sides (tests/test_torch_full_train.py)
STEP_CASES = {     # name: (mode, optimizer, mesh, grad accumulation)
    "attn_adamw": ("attn", "adamw", (1, 2, 1), 1),
    "attn_adamw8bit": ("attn", "adamw8bit", (1, 2, 1), 1),
    "attn_prodigy": ("attn", "prodigy", (1, 2, 1), 1),
    "all_adamw8bit": ("all", "adamw8bit", (1, 2, 1), 1),
    "lora_adamw": ("lora", "adamw", (1, 2, 1), 1),
    "attn_adamw_hsdp": ("attn", "adamw", (2, 1, 1), 1),
    # each microbatch reduce-scatters; FSDP sums them into the sharded grads
    "attn_adamw_accum2": ("attn", "adamw", (1, 2, 1), 2),
    # the tensor axis: each rank its tensor shard, on the whole batch
    "lora_adamw_tp": ("lora", "adamw", (1, 1, 2), 1),
    "attn_adamw_tp": ("attn", "adamw", (1, 1, 2), 1),
    "attn_adamw8bit_tp": ("attn", "adamw8bit", (1, 1, 2), 1),
    "all_adamw8bit_tp": ("all", "adamw8bit", (1, 1, 2), 1),
}
QLORA_BASES = ("weight_only", "nf4")
# the cases whose JAX reference is another's (the same whole batch and step)
SAME_REF = {"attn_adamw_hsdp": "attn_adamw", "lora_adamw_tp": "lora_adamw",
            "attn_adamw_tp": "attn_adamw", "attn_adamw8bit_tp": "attn_adamw8bit",
            "all_adamw8bit_tp": "all_adamw8bit"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tree(init, seed, rounded):
    """A JAX parameter tree made with numpy (tests/test_torch_full_train.py's
    distributions), rounded through bf16 where frozen weights are stored
    bf16 on the port's side."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name.endswith("scale"):
            x = 1 + 0.05 * rng.standard_normal(leaf.shape)
        elif name == "w":
            fan_in = np.prod(leaf.shape[:-1]) if leaf.ndim == 4 else leaf.shape[-2]
            x = rng.uniform(-1 / np.sqrt(fan_in), 1 / np.sqrt(fan_in), leaf.shape)
        else:
            x = 0.05 * rng.standard_normal(leaf.shape)
        x = torch.tensor(x, dtype=torch.float32)
        return jnp.asarray((x.bfloat16().float() if rounded else x).numpy())

    return jax.tree_util.tree_map_with_path(fill, jax.eval_shape(init, jax.random.PRNGKey(0)))


def _value(tree, name):
    """The JAX tree's value for a port parameter name, in the port's layout."""
    leaf, layer, transpose = TR.jax_leaf(name)
    x = tree
    for part in leaf.split("."):
        x = x[part]
    x = np.asarray(x)
    x = x if layer is None else x[layer]
    return x.T if transpose and x.ndim == 2 else x


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_mask(params, jtc):
    return (JTR.attn_only_mask(params, FLUX, jtc) if jtc.mode == "attn"
            else JTR.all_trainable_mask(params))


def _jax_config(mode, optimizer, accum=1):
    # Adam's eps 1e-5 (tests/test_torch_full_train.py): at 1e-8 an element
    # whose gradient is itself ~1e-8 steps by up to +-lr on a last-bit
    # difference in its sum (measured here: one element of a LoRA B 1.8e-6
    # off at lr 1e-3)
    if mode == "lora":
        return JTR.TrainConfig(mode="lora", grad_accum=1, lora_rank=4, lora_alpha=8.0,
                               learning_rate=LEARNING_RATES["lora"], adam_eps=1e-5,
                               compute_dtype="float32")
    return JTR.TrainConfig(mode=mode, optimizer=optimizer, learning_rate=LEARNING_RATES[optimizer],
                           weight_decay=0.1, adam_eps=1e-5, compute_dtype="float32",
                           grad_accum=accum)


def _jax_steps(mode, optimizer, accum, params, lora, vae, batches, keys):
    """The JAX package's train step, twice, on the whole batches."""
    jtc = _jax_config(mode, optimizer, accum)
    out = {"losses": [], "norms": []}
    if mode == "lora":
        tx = JTR.make_optimizer(jtc)
        state = tx.init(lora)
        step = jax.jit(JTR.make_lora_train_step(FLUX, VAE_TINY, jtc, tx, attn_impl="xla"))
        for batch, key in zip(batches, keys):
            lora, state, m = step(params, lora, state, vae, jax.tree.map(jnp.asarray, batch), key)
            out["losses"].append(float(m["loss"]))
            out["norms"].append(float(m["grad_norm"]))
        out["lora"] = _numpy(lora)
        return out
    mask = _jax_mask(params, jtc)
    tx = JTR.make_optimizer(jtc, mask)
    state = tx.init(params)
    step = jax.jit(JTR.make_train_step(FLUX, VAE_TINY, jtc, tx, attn_impl="xla",
                                       trainable_leaves=jax.tree.map(JTR.np_any_trainable, mask)))
    for batch, key in zip(batches, keys):
        params, state, m = step(params, state, mask, vae, jax.tree.map(jnp.asarray, batch), key)
        out["losses"].append(float(m["loss"]))
        out["norms"].append(float(m["grad_norm"]))
    out["params"] = _numpy(params)
    return out


def _data(root, rng, copies=2):
    (root / "mask").mkdir(parents=True)
    img = rng.integers(0, 255, (64, 64, 3), np.uint8)
    mask = np.zeros((64, 64), np.uint8)
    mask[16:32, 16:48] = 255
    for i in range(copies):
        Image.fromarray(img).save(root / f"s_{i}.png")
        Image.fromarray(mask).save(root / "mask" / f"s_{i}_mask.png")
        (root / f"s_{i}.txt").write_text("the text\n")
    return str(root)


def _argv(checkpoint, data, out, *extra, mode="attn", optimizer="adamw8bit"):
    return ["--model", checkpoint, "--data-dir", data, "--resolution", "64",
            "--output-dir", str(out), "--mode", mode, "--optimizer", optimizer,
            "--lora-rank", "2", "--lora-alpha", "2", "--learning-rate", "1e-3",
            "--train-batch-size", str(B), "--grad-accum", "1", "--max-sequence-length", "16",
            "--log-every", "1", "--seed", "3", "--device", "cpu", *extra]


def _state(out, step):
    return CheckpointManager(str(out / "checkpoints")).restore(step)


@pytest.fixture(scope="module")
def fsdp(tmp_path_factory):
    """Everything the file compares: the ranks' results (one spawn) and the
    JAX package's and the single-device port's on the same inputs."""
    root = tmp_path_factory.mktemp("fsdp")
    rng = np.random.default_rng(0)
    params = _tree(lambda k: init_flux_params(k, FLUX), 0, rounded=True)
    vae = _tree(lambda k: JV.init_vae_params(k, VAE_TINY), 1, rounded=False)
    lora = JTR.lora_init(jax.random.PRNGKey(3), params, FLUX, 4)
    keys = [jax.random.PRNGKey(10 + i) for i in range(2)]

    def inputs(accum):
        """Two steps' whole batches (accum, B, ...) and the JAX draws for them,
        one noise dict per microbatch."""
        batches = [{
            "pixel_values": (rng.standard_normal((accum, B, H, W, 3)) * 0.5).astype(np.float32),
            "mask": (rng.random((accum, B, H, W)) > 0.8).astype(np.float32),
            "txt": rng.standard_normal((accum, B, 6, FLUX.joint_dim)).astype(np.float32),
            "pooled": rng.standard_normal((accum, B, FLUX.pooled_dim)).astype(np.float32),
        } for _ in range(2)]
        noise = [jax_loss_noise(k, b=B, height=H, width=W, vae_cfg=VAE_TINY,
                                accum=None if accum == 1 else accum) for k in keys]
        return batches, [[x] if accum == 1 else x for x in noise]

    by_accum = {accum: inputs(accum) for accum in (1, 2)}
    common = dict(flux=_numpy(params), flux_cfg=port_cfg(FLUX), vae=_numpy(vae),
                  vae_cfg=port_cfg(VAE_TINY), lora=_numpy(lora), estim_lr0=ESTIM_LR0)
    steps = {name: dict(common, shape=shape, batches=by_accum[accum][0],
                        noise=by_accum[accum][1],
                        tc=dataclasses.asdict(port_train_config(_jax_config(mode, optimizer))))
             for name, (mode, optimizer, shape, accum) in STEP_CASES.items()}
    # QLoRA at (1, 2, 1): the base quantised (every linear) and its codes
    # storage-sharded over fsdp, against the same base on one device
    for base in QLORA_BASES:
        steps[f"qlora_{base}"] = dict(steps["lora_adamw"], quantize=base)

    # optimizer cases: the same whole gradients on every rank
    exact = _tree(lambda k: init_flux_params(k, FLUX), 2, rounded=False)
    model = port_module(exact, FLUX)
    named = dict(model.named_parameters())
    # a global norm (~0.1) under max_grad_norm: no clip, whose factor (the
    # norm summed in another order) would part the 8-bit scales by an ulp;
    # the same gradient twice, so Prodigy's D grows on the second update
    grad = {name: (1e-4 * rng.standard_normal(p.shape)).astype(np.float32)
            for name, p in named.items()}
    grads = [grad, grad]
    opt_tc = {"adamw8bit": TR.TrainConfig(mode="all", optimizer="adamw8bit",
                                          learning_rate=1e-3, weight_decay=0.1),
              # lr (a multiplier of D) 10: D grows on the second update
              "prodigy": TR.TrainConfig(mode="all", optimizer="prodigy", learning_rate=10.0,
                                        weight_decay=0.1)}
    optimizers = {"adamw8bit": dict(flux=_numpy(exact), flux_cfg=port_cfg(FLUX), shape=(1, 2, 1),
                                    tc=dataclasses.asdict(opt_tc["adamw8bit"]), grads=grads[:1]),
                  "adamw8bit_tp": dict(flux=_numpy(exact), flux_cfg=port_cfg(FLUX),
                                       shape=(1, 1, 2), tc=dataclasses.asdict(opt_tc["adamw8bit"]),
                                       grads=grads[:1]),
                  "prodigy": dict(flux=_numpy(exact), flux_cfg=port_cfg(FLUX), shape=(1, 2, 1),
                                  tc=dataclasses.asdict(opt_tc["prodigy"]), grads=grads,
                                  estim_lr0=ESTIM_LR0)}

    # main(): a tiny checkpoint, a data directory, and a checkpoint written
    # on one device (E) for the ranks to resume
    ckpt = write_tiny_checkpoint(str(root / "ckpt"))
    data = _data(root / "data", rng)
    CLI.main(_argv(ckpt, data, root / "E", "--max-train-steps", "2",
                   "--checkpointing-steps", "2"))
    shutil.copytree(root / "E" / "checkpoints", root / "E2" / "checkpoints")
    main = [
        ("A", {"argv": _argv(ckpt, data, root / "A", "--max-train-steps", "3",
                             "--checkpointing-steps", "1")}),
        ("B1", {"argv": _argv(ckpt, data, root / "B", "--max-train-steps", "2",
                              "--checkpointing-steps", "1")}),
        ("B2", {"argv": _argv(ckpt, data, root / "B", "--max-train-steps", "3",
                              "--checkpointing-steps", "1", "--resume-from-checkpoint",
                              "latest"), "capture": True}),
        ("E2", {"argv": _argv(ckpt, data, root / "E2", "--max-train-steps", "2",
                              "--resume-from-checkpoint", "latest"), "capture": True}),
        ("C", {"argv": _argv(ckpt, data, root / "C", "--max-train-steps", "2",
                             "--checkpointing-steps", "2", mode="lora", optimizer="adamw")}),
        ("D", {"argv": _argv(ckpt, data, root / "D", "--max-train-steps", "50",
                             "--checkpointing-steps", "100", mode="all"), "sigterm": True}),
        # the tensor axis: T at (1, 1, 2); its checkpoints resumed at (1, 2, 1)
        # (TF), A's at (1, 1, 2) (AT); LoRA at (1, 1, 2) (CT); QLoRA over an
        # NF4 base at (1, 2, 1) (Q)
        ("T", {"argv": _argv(ckpt, data, root / "T", "--mesh", "1,1,2", "--max-train-steps",
                             "3", "--checkpointing-steps", "1")}),
        ("TF", {"argv": _argv(ckpt, data, root / "TF", "--mesh", "1,2,1", "--max-train-steps",
                              "3", "--resume-from-checkpoint", "latest"), "capture": True,
                "copy": (str(root / "T" / "checkpoints"), str(root / "TF" / "checkpoints"))}),
        ("AT", {"argv": _argv(ckpt, data, root / "AT", "--mesh", "1,1,2", "--max-train-steps",
                              "3", "--resume-from-checkpoint", "latest"), "capture": True,
                "copy": (str(root / "A" / "checkpoints"), str(root / "AT" / "checkpoints"))}),
        # T's step-2 checkpoint resumed at (1, 1, 2) to step 3 (TR)
        ("TR", {"argv": _argv(ckpt, data, root / "TR", "--mesh", "1,1,2", "--max-train-steps",
                              "3", "--checkpointing-steps", "1", "--resume-from-checkpoint",
                              "latest"),
                "copy": (str(root / "T" / "checkpoints" / "2"),
                         str(root / "TR" / "checkpoints" / "2"))}),
        ("CT", {"argv": _argv(ckpt, data, root / "CT", "--mesh", "1,1,2", "--max-train-steps",
                              "2", "--checkpointing-steps", "2", mode="lora", optimizer="adamw")}),
        ("Q", {"argv": _argv(ckpt, data, root / "Q", "--mesh", "1,2,1", "--max-train-steps",
                             "2", "--checkpointing-steps", "2", "--quantize-base", "nf4",
                             mode="lora", optimizer="adamw")}),
    ]
    load = dict(path=str(root / "ckpt" / "transformer"), cfg=port_cfg(FLUX_CFG))
    spec = dict(steps=steps, optimizers=optimizers, main=main, load=load)

    with D.Ranks(D.fsdp_cases, 2, spec) as ranks, pytest.MonkeyPatch.context() as mp:
        mp.setattr(optax.contrib, "prodigy",
                   functools.partial(optax.contrib.prodigy, estim_lr0=ESTIM_LR0))
        mp.setattr(TR.ClippedProdigy, "estim_lr0", ESTIM_LR0)
        refs = {}
        for name, (mode, optimizer, _, accum) in STEP_CASES.items():
            if name not in SAME_REF:
                refs[name] = _jax_steps(mode, optimizer, accum, params, lora, vae,
                                        by_accum[accum][0], keys)
        refs.update({name: refs[other] for name, other in SAME_REF.items()})

        # 8-bit codes: JAX's masked update on the same gradients
        jtc = JTR.TrainConfig(mode="all", optimizer="adamw8bit", learning_rate=1e-3,
                              weight_decay=0.1)
        mask = _jax_mask(exact, jtc)
        tx = JTR.make_optimizer(jtc, mask)
        jgrads = jax.tree.map(jnp.zeros_like, exact)
        for name in named:
            leaf, layer, transpose = TR.jax_leaf(name)
            g = grads[0][name].T if transpose and grads[0][name].ndim == 2 else grads[0][name]
            node = jgrads
            *head, last = leaf.split(".")
            for part in head:
                node = node[part]
            node[last] = node[last].at[layer].set(g) if layer is not None else jnp.asarray(g)

        @jax.jit
        def jax_update(g, state, p):
            updates, state = tx.update(JTR.apply_mask(g, mask), state, p)
            return optax.apply_updates(p, JTR.apply_mask(updates, mask)), state

        jparams, jstate = jax_update(jgrads, tx.init(exact), exact)
        codes = dict(params=_numpy(jparams), inner=jstate[1].inner_state[0],
                     grads=_numpy(jgrads), b1=jtc.adam_b1, b2=jtc.adam_b2)

        # the global norm and Prodigy's D on one device, same gradients
        single = port_module(exact, FLUX)
        sopt = TR.make_optimizer(opt_tc["prodigy"], dict(single.named_parameters()))
        snorms = []
        for g in grads:
            sopt.zero_grad()
            for name, p in single.named_parameters():
                p.grad = torch.tensor(g[name])
            snorms.append(float(sopt.step()))
        prodigy = dict(norms=snorms, d=float(sopt.state["estim_lr"]))
        qlora = {base: _one_device_steps(steps[f"qlora_{base}"]) for base in QLORA_BASES}
        results = ranks.results(timeout=240)
    for r, res in enumerate(results):
        assert "error" not in res, f"rank {r}: {res['error']}"
    return types.SimpleNamespace(ranks=results, refs=refs, codes=codes, prodigy=prodigy,
                                 qlora=qlora, root=root, ckpt=ckpt, data=data, params=params,
                                 lora=lora)


def _one_device_steps(case):
    """A step case's steps on this process alone (no mesh, the whole batch)."""
    one = types.SimpleNamespace(tensor=1, batch_shards=1)
    model, vae, opt, step, named = D._train_model(case, one)
    losses, norms = [], []
    for batch, noise in zip(case["batches"], case["noise"]):
        got = step(model, vae, opt, {k: torch.tensor(v) for k, v in batch.items()},
                   noise=[{k: torch.tensor(v) for k, v in mb.items()} for mb in noise])
        losses.append(float(got["loss"]))
        norms.append(float(got["grad_norm"]))
    return dict(losses=losses, norms=norms,
                params={n: p.detach().float().numpy() for n, p in model.named_parameters()
                        if p.requires_grad})


def _ok(res):
    assert isinstance(res, dict) and "error" not in res, res.get("error") if isinstance(
        res, dict) else res
    return res


# ---------------------------------------------------------------------------
# the block-forward refactor: flux_apply without a mesh is bitwise as before
# ---------------------------------------------------------------------------

def _flux_apply_as_before(model, img, txt, pooled, timestep, guidance, cos, sin, *, attn_impl,
                          remat):
    """flux_apply as it ran before the blocks became module calls: the
    block functions called directly, each block's modulation computed
    outside it, the checkpoint around the function."""
    from torch.utils.checkpoint import checkpoint

    cfg, dtype, n_txt = model.cfg, img.dtype, txt.shape[1]
    sv = TT.silu(TT.flux_vec(model, timestep, guidance, pooled, dtype))
    double_mods = ((TT.dense(b.img_mod, sv), TT.dense(b.txt_mod, sv))
                   for b in model.double_blocks)
    single_mods = (TT.dense(b.mod, sv) for b in model.single_blocks)
    final = TT.dense(model.final_mod, sv)
    x_img, x_txt = TT.dense(model.img_in, img), TT.dense(model.txt_in, txt.to(dtype))
    cos, sin = cos.float(), sin.float()

    def call(fn, *args):
        return checkpoint(fn, *args, use_reentrant=False) if remat else fn(*args)

    for blk, m in zip(model.double_blocks, double_mods):
        x_txt, x_img = call(TT.double_block, blk, cfg, x_txt, x_img, m, cos, sin, attn_impl,
                            None, None)
    x = torch.cat([x_txt, x_img], dim=1)
    for blk, m in zip(model.single_blocks, single_mods):
        x = call(TT.single_block, blk, cfg, x, m, cos, sin, attn_impl, None, None)
    x = x[:, n_txt:]
    scale, shift = final.chunk(2, dim=-1)
    x = TT.layer_norm(x) * (1.0 + scale[:, None]) + shift[:, None]
    return torch.cat([TT.dense(model.final_proj, x[i:i + 1]) for i in range(x.shape[0])])


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("impl", ["plain", "flash", "fused"])
def test_flux_apply_is_bitwise_as_before(impl, remat):
    """The blocks' forward (each with its own modulation linears, the unit
    FSDP hooks) gives bitwise the output and the gradients of the block
    functions called directly, on every attention path, with and without
    remat (the fused path has no backward)."""
    cfg = port_cfg(FLUX)
    model = TT.FluxTransformer(cfg, device="cpu")
    for p in model.parameters():   # frozen-weight storage as in training
        if p.dim() == 2:
            p.data = p.data.bfloat16()
    tables = rope_tables
    if impl == "fused":
        TT.half_permute_flux_params(model)
        tables = rope_tables_half
    ids = np.concatenate([packing.text_ids(6), packing.latent_image_ids(8, 8)])
    cos, sin = (torch.as_tensor(x) for x in tables(ids, cfg.axes_dims_rope))
    g = torch.Generator().manual_seed(1)
    args = [torch.randn(2, 16, cfg.in_channels, generator=g), torch.randn(2, 6, cfg.joint_dim,
                                                                           generator=g),
            torch.randn(2, cfg.pooled_dim, generator=g), torch.rand(2, generator=g),
            torch.full((2,), 3.5)]
    outs = []
    for apply in (_flux_apply_as_before, TT.flux_apply):
        model.zero_grad()
        y = apply(model, *args, cos, sin, attn_impl=impl, remat=remat)
        if impl != "fused":
            y.square().mean().backward()
        outs.append((y.detach(), [None if p.grad is None else p.grad.clone()
                                  for p in model.parameters()]))
    assert torch.equal(outs[0][0], outs[1][0])
    for a, b in zip(outs[0][1], outs[1][1]):
        assert (a is None and b is None) or torch.equal(a, b)
    if impl != "fused":
        assert all(x is not None for x in outs[1][1])


# ---------------------------------------------------------------------------
# train steps over the mesh against the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(STEP_CASES))
def test_steps_match_jax(case, fsdp):
    """Two steps over 2 ranks (each on its row of the whole batch, with its
    row of the whole batch's draws) against the JAX step on the whole
    batch: the loss (the ranks' mean) and grad norm, and every tensor
    gathered whole; the frozen ones and masked elements as they were."""
    mode, optimizer, _, _ = STEP_CASES[case]
    want = fsdp.refs[case]
    got = [_ok(r[f"step:{case}"]) for r in fsdp.ranks]
    rtol = 1e-4 if mode == "lora" else 1e-5
    for g in got:
        np.testing.assert_allclose(g["losses"], want["losses"], rtol=rtol)
        np.testing.assert_allclose(g["norms"], want["norms"], rtol=rtol)
    params = got[0]["params"]
    if mode == "lora":
        factors = load_jax_lora(want["lora"], port_module(fsdp.params, FLUX))
        for name, x in params.items():
            path, _, k = name.rpartition(".")
            if k not in ("lora_a", "lora_b", "lora_ga", "lora_gb"):
                np.testing.assert_array_equal(x, _value(fsdp.params, name), err_msg=name)
                continue
            np.testing.assert_allclose(x, n(factors[path][k[-1]]), rtol=1e-4,
                                       atol=1e-3 * LEARNING_RATES["lora"], err_msg=name)
        assert len(got[0]["trained"]) == 2 * (8 * FLUX.num_double_layers
                                              + FLUX.num_single_layers)
        return
    masks = TR.trainable_mask(TT.FluxTransformer(port_cfg(FLUX), device="meta"),
                              port_train_config(_jax_config(mode, optimizer)))
    moved = 0
    for name, x in params.items():
        target, before = _value(want["params"], name), _value(fsdp.params, name)
        tol = 1e-5 * float(np.abs(target).max())
        np.testing.assert_allclose(x, target, rtol=0, atol=tol, err_msg=name)
        if name not in masks:
            np.testing.assert_array_equal(x, before, err_msg=name)
            continue
        m = masks[name]
        frozen = (np.zeros(x.shape, bool) if m is None
                  else np.broadcast_to(n(m) == 0, x.shape))
        np.testing.assert_array_equal(x[frozen], before[frozen], err_msg=name)
        moved = max(moved, float(np.abs(x - before)[~frozen].max()) / tol)
    assert moved > 10
    if optimizer == "adamw8bit":   # both the local-block and the gathered-leaf paths ran
        assert 0 < got[0]["local_leaves"] < got[0]["leaves"]


@pytest.mark.parametrize("base", QLORA_BASES)
def test_qlora_over_fsdp_matches_one_device(base, fsdp):
    """QLoRA (rank 4, AdamW) over a base quantised in every linear, at (1,
    2, 1): each rank keeps half of the codes and scales (storage shards,
    gathered block by block, never cast) and its FSDP slice of the factors,
    against the same base on one device on the same batch: loss and grad
    norm within 1e-5 relative, every factor within 1e-3 of a step (the
    single-device LoRA tolerance)."""
    want = fsdp.qlora[base]
    for r in fsdp.ranks:
        got = _ok(r[f"step:qlora_{base}"])
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
        np.testing.assert_allclose(got["norms"], want["norms"], rtol=1e-5)
        assert got["counts"]["all_gather_storage"] > 0
    params = _ok(fsdp.ranks[0][f"step:qlora_{base}"])["params"]
    assert want["params"] and all(".lora_" in name for name in want["params"])
    for name, y in want["params"].items():
        np.testing.assert_allclose(params[name], y, rtol=0,
                                   atol=1e-3 * LEARNING_RATES["lora"], err_msg=name)


def _code_boundary(moment, scale):
    """Each element's distance, in code units, from the nearest rounding
    boundary of the log-domain code (float64): where it is within float32
    rounding, the two libraries' float32 log may round either way."""
    blocks = np.pad(moment.reshape(-1), (0, scale.size * 256 - moment.size)).reshape(-1, 256)
    t = np.abs(blocks) / np.maximum(scale[:, None], 1e-30)
    v = 127.0 * (1.0 + np.log(np.maximum(t, 1e-5)) / 11.512925464970229)
    return np.abs(v - np.floor(v) - 0.5)


@pytest.mark.parametrize("case", ["adamw8bit", "adamw8bit_tp"])
def test_8bit_codes_are_the_jax_blocks(case, fsdp):
    """One 8-bit AdamW update over 2 ranks (fsdp, or the tensor axis: each
    rank its device-major shard) on the same gradients as JAX's (a global
    norm under the clip): the state, gathered into its whole natural
    layout, holds JAX's block scales bitwise and JAX's codes bitwise, for
    the leaves whose slices are whole blocks (kept and updated per rank)
    and for the others (gathered whole). The one exception is an element
    whose log-domain value lies within float32 rounding (1e-4 of a code) of
    a code boundary: torch's and XLA's float32 log differ in the last bit
    and round it one code apart (the single-device port too: 2 such
    elements in this model's 1.2 M, in other leaves). The parameters
    match."""
    got = _ok(fsdp.ranks[0][f"opt:{case}"])
    inner, grads = fsdp.codes["inner"], fsdp.codes["grads"]
    assert any(got["local"]) and not all(got["local"])
    at_boundary = 0
    for j, leaf in enumerate(got["leaf_names"]):
        node_mu, node_nu, g = inner.mu, inner.nu, grads
        for part in leaf.split("."):
            node_mu, node_nu, g = node_mu[part], node_nu[part], g[part]
        g = np.asarray(g, np.float64)
        for m, node, moment in (("mu", node_mu, (1 - fsdp.codes["b1"]) * g),
                                ("nu", node_nu, (1 - fsdp.codes["b2"]) * g * g)):
            q, scale = (np.asarray(x) for x in node)
            ours = got["state"]["adamw8bit"]
            np.testing.assert_array_equal(ours[f"{m}_scale"][j], scale, err_msg=leaf)
            differ = ours[f"{m}_q"][j] != q
            if differ.any():
                off = np.abs(ours[f"{m}_q"][j].astype(int) - q.astype(int))[differ]
                near = _code_boundary(moment, scale)[differ]
                assert off.max() == 1 and near.max() < 1e-4, (leaf, m, off, near)
                at_boundary += int(differ.sum())
    assert at_boundary <= 8
    for name, x in got["params"].items():
        want = _value(fsdp.codes["params"], name)
        np.testing.assert_allclose(x, want, rtol=0, atol=1e-6 * np.abs(want).max(), err_msg=name)


def test_norm_and_prodigy_d_match_one_device(fsdp):
    """Prodigy over 2 ranks, two updates on the same gradients as one
    device's: the global norms within 1e-6 relative (the square root of the
    local squares summed over the fsdp ranks) and D within 1e-5 (the
    inner product and the L1 sum over the ranks). D is a ratio of two
    float32 sums over 1.2 M products, one dot per tensor on one rank and one
    per slice on two, then an all-reduce: on one draw of gradients the two
    came 1.64e-6 apart, and nothing here
    orders them alike without gathering every tensor."""
    for r in fsdp.ranks:
        got = _ok(r["opt:prodigy"])
        np.testing.assert_allclose(got["norms"], fsdp.prodigy["norms"], rtol=1e-6)
    d = float(_ok(fsdp.ranks[0]["opt:prodigy"])["state"]["prodigy"]["estim_lr"])
    assert d > ESTIM_LR0
    np.testing.assert_allclose(d, fsdp.prodigy["d"], rtol=1e-5)


def test_sharded_load_is_the_whole_load(fsdp):
    """Each rank's slices read straight from the checkpoint files
    (load_flux_fsdp), gathered, are the whole load's parameters bitwise, in
    --mode attn's dtypes (float32 masters, bf16 frozen weights)."""
    got = _ok(fsdp.ranks[0]["load"])
    cfg = port_cfg(FLUX_CFG)
    masks = TR.trainable_mask(TT.FluxTransformer(cfg, device="meta"),
                              TR.TrainConfig(mode="attn"))
    want = load_flux_transformer(str(fsdp.root / "ckpt" / "transformer"), cfg, device="cpu",
                                 dtype=TR.mask_dtypes(masks, lambda name: torch.bfloat16))
    assert set(got["params"]) == {n for n, _ in want.named_parameters()}
    for name, p in want.named_parameters():
        assert got["dtypes"][name] == str(p.dtype), name
        np.testing.assert_array_equal(got["params"][name], n(p.float()), err_msg=name)


# ---------------------------------------------------------------------------
# main() over the mesh: checkpoints, resume, export, SIGTERM
# ---------------------------------------------------------------------------

def _main(fsdp, run):
    res = [_ok(r["main"]) for r in fsdp.ranks]
    for r in res:
        assert r[run].get("ok"), r[run].get("error")
    return res[0][run]


def _assert_trees_equal(got, want, path="state"):
    if isinstance(want, torch.Tensor):
        w = want.float().numpy() if want.dtype == torch.bfloat16 else want.numpy()
        assert got.dtype == w.dtype and got.shape == w.shape, path
        np.testing.assert_array_equal(got, w, err_msg=path)
    elif isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_trees_equal(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (x, y) in enumerate(zip(got, want)):
            _assert_trees_equal(x, y, f"{path}[{i}]")
    else:
        assert got == want, path


def _resume_on_one_device(fsdp, out, monkeypatch):
    """main() on one device resuming run `out`'s latest checkpoint (step 3):
    the live state right after the resume, in the checkpoint's layout."""
    root = fsdp.root / f"{out}1"
    shutil.copytree(fsdp.root / out / "checkpoints", root / "checkpoints")
    seen = {}
    load = CLI.load_full_train_state

    def capture(flux, opt, state):
        s = load(flux, opt, state)
        seen["state"] = D.torch_tree_to_numpy(CLI.full_train_state(flux, opt, s))
        return s

    monkeypatch.setattr(CLI, "load_full_train_state", capture)
    CLI.main(_argv(fsdp.ckpt, fsdp.data, root, "--max-train-steps", "3",
                   "--resume-from-checkpoint", "latest"))
    return seen["state"]


@pytest.mark.parametrize("written,read", [(2, 2), (1, 2), (2, 1)])
def test_checkpoint_restores_bitwise_at_any_fsdp(written, read, fsdp, monkeypatch):
    """A checkpoint (the whole tensors: parameters in their dtypes, 8-bit
    codes and scales, count, step) written at one fsdp size and resumed at
    another holds, right after the resume, every tensor of the file
    bitwise."""
    if read == 2:
        run, out, step = ("B2", "B", 2) if written == 2 else ("E2", "E", 2)
        restored = _main(fsdp, run)["restored"]
    else:   # one device resumes A's (fsdp = 2) step-3 checkpoint
        out, step = "A", 3
        restored = _resume_on_one_device(fsdp, out, monkeypatch)
    want = _state(fsdp.root / out, step)
    assert restored["step"] == step and restored["opt_state"]["count"] == step
    _assert_trees_equal(restored, want)


def _assert_resume_continues(fsdp, straight, resumed):
    """Run `resumed` (2 steps, then a resume to step 3) ends bitwise where
    the straight 3-step run `straight` ends: its step-3 checkpoint and its
    export."""
    want, got = _state(fsdp.root / straight, 3), _state(fsdp.root / resumed, 3)
    _assert_trees_equal(D.torch_tree_to_numpy(got), want)
    for f in ("diffusion_pytorch_model.safetensors", "config.json"):
        assert ((fsdp.root / straight / "transformer" / f).read_bytes()
                == (fsdp.root / resumed / "transformer" / f).read_bytes()), f


def test_resume_continues_bitwise(fsdp):
    """At fsdp = 2: 2 steps, then a resume to step 3, end bitwise where the
    straight 3-step run ends (its step-3 checkpoint and its export)."""
    _main(fsdp, "A"), _main(fsdp, "B2")
    _assert_resume_continues(fsdp, "A", "B")


def test_resume_continues_bitwise_at_tp2(fsdp):
    """At tp = 2: the straight 3-step run's step-2 checkpoint, resumed to
    step 3, ends bitwise where the straight run ends (its step-3 checkpoint
    and its export)."""
    _main(fsdp, "T"), _main(fsdp, "TR")
    _assert_resume_continues(fsdp, "T", "TR")


@pytest.mark.parametrize("written,read", [("1,1,2", "1,2,1"), ("1,1,2", "1,1,1"),
                                          ("1,2,1", "1,1,2")])
def test_checkpoint_restores_bitwise_across_the_tensor_axis(written, read, fsdp, monkeypatch):
    """A checkpoint written with the weights split over a tensor axis holds
    them (and the 8-bit codes) whole in the natural layout: resumed at
    fsdp = 2 or on one device it restores bitwise, and one written at fsdp
    = 2 restores bitwise at tp = 2."""
    out = {"1,1,2": "T", "1,2,1": "A"}[written]
    if read == "1,1,1":
        restored = _resume_on_one_device(fsdp, out, monkeypatch)
    else:
        restored = _main(fsdp, {"1,2,1": "TF", "1,1,2": "AT"}[read])["restored"]
    want = _state(fsdp.root / out, 3)
    assert restored["step"] == 3 and restored["opt_state"]["count"] == 3
    _assert_trees_equal(restored, want)


@pytest.mark.parametrize("full,lora", [("A", "C"), ("T", "CT")])
def test_export_is_the_one_device_export(full, lora, fsdp, tmp_path):
    """Rank 0's float32 export of the sharded DiT and its LoRA export are,
    byte for byte, what the single-device exporters write of the same
    weights gathered whole (the final checkpoints'): over fsdp = 2, and
    over tp = 2 (the tensor shards gathered and un-permuted)."""
    _main(fsdp, full), _main(fsdp, lora)
    state = _state(fsdp.root / full, 3)
    whole = TT.FluxTransformer(port_cfg(FLUX_CFG), device="meta")
    for name, t in state["params"].items():
        path, _, leaf = name.rpartition(".")
        whole.get_submodule(path)._parameters[leaf] = torch.nn.Parameter(t.clone(),
                                                                         requires_grad=False)
    save_transformer_checkpoint(whole, str(tmp_path / "transformer"), dtype=torch.float32)
    name = "diffusion_pytorch_model.safetensors"
    assert ((tmp_path / "transformer" / name).read_bytes()
            == (fsdp.root / full / "transformer" / name).read_bytes())

    factors = _state(fsdp.root / lora, 2)["lora"]
    save_safetensors(export_lora_state_dict(factors, port_cfg(FLUX_CFG), 2.0, rank=2),
                     str(tmp_path / "lora.safetensors"))
    assert ((tmp_path / "lora.safetensors").read_bytes()
            == (fsdp.root / lora / "pytorch_lora_weights.safetensors").read_bytes())


def test_sigterm_on_one_rank_stops_every_rank(fsdp):
    """A SIGTERM that reaches rank 0 alone: the ranks agree after the step,
    both leave the loop, the checkpoint of that step is written and
    nothing is exported."""
    _main(fsdp, "D")
    log = [json.loads(x) for x in (fsdp.root / "D" / "train_log.jsonl").read_text()
           .splitlines()]
    assert log[-1].get("preempted") is True
    stop = log[-1]["step"]
    assert 1 <= stop < 50
    assert CheckpointManager(str(fsdp.root / "D" / "checkpoints")).all_steps() == [stop]
    assert not (fsdp.root / "D" / "transformer").exists()


# ---------------------------------------------------------------------------
# what main() refuses
# ---------------------------------------------------------------------------

def test_batch_must_split_over_data_x_fsdp(fsdp):
    """The JAX trainer's exit, with its message, before any process group
    is needed."""
    with pytest.raises(SystemExit, match=r"must be divisible by the mesh's data x fsdp "
                                         r"product \(1x2=2\)"):
        CLI.main(_argv(fsdp.ckpt, fsdp.data, fsdp.root / "X", "--mesh", "1,2,1",
                       "--train-batch-size", "1"))


@pytest.mark.parametrize("run", ["T", "CT", "Q"])
def test_main_runs_what_was_refused(run, fsdp):
    """What main() refused before (a tensor axis in training, --mode attn
    and --mode lora; --quantize-base over fsdp > 1) runs over the 2 ranks:
    finite losses logged at every step, a checkpoint and an export. (Data
    x tensor meshes run in tests/test_torch_tp_train.py at (2, 2, 2).)"""
    _main(fsdp, run)
    steps = {"T": 3, "CT": 2, "Q": 2}[run]
    log = [json.loads(x) for x in (fsdp.root / run / "train_log.jsonl").read_text()
           .splitlines()]
    assert [e["step"] for e in log] == list(range(1, steps + 1))
    assert all(np.isfinite(e["loss"]) and np.isfinite(e["grad_norm"]) for e in log)
    assert steps in CheckpointManager(str(fsdp.root / run / "checkpoints")).all_steps()
    export = ("transformer/diffusion_pytorch_model.safetensors" if run == "T"
              else "pytorch_lora_weights.safetensors")
    assert (fsdp.root / run / export).exists()


def test_tensor_axis_decisions():
    """Decided once per parameter from the specs: which parameters a
    tensor axis splits (along which axis, with the device-major share of a
    fused projection), and which replicated ones have a gradient that is a
    rank's part, summed over the tensor ranks (the q/k norm scales of a
    block whose heads are split, the LoRA factors of a split linear) or
    whole on each (the embedders, the output head, a row-parallel bias, the
    factors of a replicated linear)."""
    cfg = port_cfg(FLUX)
    model = TT.FluxTransformer(cfg, device="cpu")
    lora = TR.lora_init(model, 2, generator=torch.Generator().manual_seed(1))
    head = model.final_proj   # a replicated linear carrying factors too
    lora["final_proj"] = {"a": torch.randn(head.in_features, 2),
                          "b": torch.zeros(2, head.out_features)}
    TR.lora_insert(model, lora, 1.0)
    TT.tp_permute_flux_params(model, 2)
    PT.shard_module(model, PT.flux_param_specs(cfg), types.SimpleNamespace(tensor=2,
                                                                             tensor_rank=1))
    split, partial = {}, set()
    for name, _ in model.named_parameters():
        x = PT.tensor_split(model, name)
        if x is not None:
            split[name] = (x[0], x[1].kind)
        if PT.partial_over_tensor(model, name):
            partial.add(name)
    assert split["double_blocks.0.img_qkv.weight"] == (0, PT.COLUMN)
    assert split["double_blocks.0.img_qkv.bias"] == (0, PT.COLUMN)
    assert split["double_blocks.0.img_proj.weight"] == (1, PT.ROW)
    assert split["single_blocks.1.linear2.weight"] == (1, PT.ROW)
    assert split["img_in.weight"] == (0, PT.COLUMN)
    for name in ("double_blocks.0.img_proj.bias", "single_blocks.0.linear2.bias",
                 "final_proj.weight", "final_mod.bias", "time_in.fc1.weight",
                 "double_blocks.0.img_q_scale", "single_blocks.0.linear1.lora_ga"):
        assert name not in split, name
    assert partial == {n for n, _ in model.named_parameters()
                       if n.endswith(("_scale", ".lora_a", ".lora_b", ".lora_ga", ".lora_gb"))
                       and not n.startswith("final_proj.")}
    # the optimizer's names of the factors ("<linear path>.a" / ".b")
    assert PT.partial_over_tensor(model, "double_blocks.0.img_qkv.a")
    assert not PT.partial_over_tensor(model, "final_proj.b")
    assert not any(n.startswith(("time_in", "vector_in", "guidance_in", "final_"))
                   for n in partial)
    # the rank's share of a fused projection: its head's q, k and v rows
    share = model.double_blocks[0].img_qkv.tp_share
    d = cfg.hidden_dim
    assert share.index().tolist() == [j for s in (0, d, 2 * d) for j in range(s + d // 2, s + d)]
    assert model.single_blocks[0].linear1.lora_ga.shape[1:] == (d, 2)   # factors stay whole
    assert PT.serving_mesh_shape("1,2,1") == (1, 2, 1)
