"""The port's training entry points on the CPU: Prodigy against optax, the
LoRA warm start against the JAX package's import, the checkpoint manager,
the per-step noise stream over a resume (train_lora and main()), and
cli.train.main() end to end on a tiny diffusers-layout checkpoint: export
and serving round trip (AdamW, Prodigy and 8-bit AdamW), SIGTERM
preemption, the loader's worker processes, its SystemExits and the choices
that were ported after it (the full-parameter modes:
tests/test_torch_full_train.py)."""

import dataclasses
import glob
import json
import multiprocessing
import os
import signal
import threading
import time

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch
from PIL import Image

from textflux_tpu.io.lora import import_lora_factors as jax_import_lora_factors
from textflux_tpu.training import train as JT

import textflux_torch.config as TC
from textflux_torch.cli import train as CLI
from textflux_torch.data.loader import SHM_DIR
from textflux_torch.io.lora import import_lora_factors
from textflux_torch.io.params import load_safetensors_dir
from textflux_torch.io.safetensors import save_file
from textflux_torch.models.clip import CLIPTextModel
from textflux_torch.models.t5 import T5Encoder
from textflux_torch.models.transformer import FluxTransformer
from textflux_torch.models.vae import FluxVAE
from textflux_torch.pipeline.fill import FillPipeline
from textflux_torch.training import train as TR
from textflux_torch.training.checkpoint import CheckpointManager

from torch_port_helpers import (CLIP_CFG, FLUX_CFG, T5_CFG, VAE_CFG, port_cfg,
                                write_tiny_checkpoint)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tiny models' ops gain nothing from threads, and torch's threads
    contend with the JAX CPU backend's in this process (a main() run takes
    ~10x longer with both at 8)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# Prodigy
# ---------------------------------------------------------------------------

PRODIGY_CASES = {
    "lr1_constant": dict(),
    "warmup_safeguard": dict(lr_warmup_steps=3, prodigy_safeguard_warmup=True),
    "beta3": dict(prodigy_beta3=0.9),
    "cosine_decay": dict(lr_scheduler="cosine", max_train_steps=6, weight_decay=0.1),
}


def _run_both(tc, tx, p0, targets, steps=5):
    """`steps` clipped updates on both sides, the gradient 3 (p - target)
    of each side's own parameters (norm ~10: the clip is active)."""
    params = [jnp.asarray(x) for x in p0]
    state = tx.init(params)
    ours = [torch.nn.Parameter(torch.tensor(x)) for x in p0]
    opt = TR.make_optimizer(tc, {f"p{i}": p for i, p in enumerate(ours)})
    for _ in range(steps):
        grads = [3 * (np.asarray(p) - y) for p, y in zip(params, targets)]
        updates, state = tx.update([jnp.asarray(g) for g in grads], state, params)
        params = optax.apply_updates(params, updates)
        for p, y in zip(ours, targets):
            p.grad = 3 * (p.detach() - torch.tensor(y))
        opt.step()
    return params, state[1], ours, opt


@pytest.mark.parametrize("case", list(PRODIGY_CASES))
def test_prodigy_matches_optax(case, rng, monkeypatch):
    """Both sides start the D estimate at 1e-2, so 5 steps move the
    parameters by ~5e-2 and grow D; held within 1e-6 in float32."""
    p0 = [(0.5 * rng.standard_normal(s)).astype(np.float32) for s in ((5, 3), (4,), (2, 3, 2))]
    targets = [rng.standard_normal(x.shape).astype(np.float32) for x in p0]
    tc = TR.TrainConfig(optimizer="prodigy", learning_rate=1.0, **PRODIGY_CASES[case])
    jtc = JT.TrainConfig(**{f.name: getattr(tc, f.name) for f in dataclasses.fields(tc)})
    monkeypatch.setattr(TR.ClippedProdigy, "estim_lr0", 1e-2)
    tx = optax.chain(optax.clip_by_global_norm(tc.max_grad_norm), optax.contrib.prodigy(
        learning_rate=JT.make_lr_schedule(jtc), betas=(tc.adam_b1, tc.adam_b2),
        beta3=tc.prodigy_beta3, eps=tc.adam_eps, estim_lr0=1e-2,
        safeguard_warmup=tc.prodigy_safeguard_warmup, weight_decay=tc.weight_decay))
    params, jstate, ours, opt = _run_both(tc, tx, p0, targets)
    moved = max(float(np.abs(np.asarray(p) - x).max()) for p, x in zip(params, p0))
    assert moved > 1e-2
    for p, q in zip(params, ours):
        np.testing.assert_allclose(q.detach().numpy(), np.asarray(p), rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(opt.state["estim_lr"]), float(jstate.estim_lr), rtol=1e-4)
    # the state holds copies of the initial parameters, not the live ones
    for p0_ours, x, p in zip(opt.state["params0"], p0, ours):
        np.testing.assert_array_equal(p0_ours.numpy(), x)
        assert p0_ours.data_ptr() != p.data_ptr()


def test_prodigy_matches_jax_make_optimizer(rng):
    """The JAX trainer's own chain (default D estimate 1e-6)."""
    p0 = [(0.5 * rng.standard_normal(s)).astype(np.float32) for s in ((6, 2), (3,))]
    targets = [rng.standard_normal(x.shape).astype(np.float32) for x in p0]
    tc = TR.TrainConfig(optimizer="prodigy", learning_rate=1.0)
    jtc = JT.TrainConfig(**{f.name: getattr(tc, f.name) for f in dataclasses.fields(tc)})
    params, jstate, ours, opt = _run_both(tc, JT.make_optimizer(jtc), p0, targets)
    for p, q in zip(params, ours):
        np.testing.assert_allclose(q.detach().numpy(), np.asarray(p), rtol=0, atol=1e-6)
    assert float(jstate.estim_lr) > 1e-6
    np.testing.assert_allclose(float(opt.state["estim_lr"]), float(jstate.estim_lr), rtol=1e-4)
    assert opt.count == int(jstate.count) == 5


def test_make_optimizer_refuses_adamw8bit():
    """adamw8bit is ported (held to JAX in test_torch_quantize.py): it gives
    the 8-bit optimizer; an optimizer name the trainer lacks is refused."""
    assert isinstance(TR.make_optimizer(TR.TrainConfig(optimizer="adamw8bit"),
                                        {"p": torch.zeros(2)}), TR.ClippedAdamW8bit)
    with pytest.raises(ValueError, match="unknown optimizer 'adamw4bit'"):
        TR.make_optimizer(TR.TrainConfig(optimizer="adamw4bit"), {"p": torch.zeros(2)})


# ---------------------------------------------------------------------------
# the LoRA warm start
# ---------------------------------------------------------------------------

def _lora_file(rng, *, rank=2):
    """A peft LoRA over FLUX_CFG (hidden 16, mlp 64): img_qkv on both double
    layers, txt_proj and single linear1 on one layer each (the other layer
    is absent), an alpha on some modules; img_mlp.fc1 absent altogether."""
    d, m = FLUX_CFG.hidden_dim, FLUX_CFG.mlp_dim
    mods = {f"transformer_blocks.{i}.attn.{q}": (d, d)
            for i in (0, 1) for q in ("to_q", "to_k", "to_v")}
    mods["transformer_blocks.1.attn.to_add_out"] = (d, d)
    mods["transformer_blocks.0.ff_context.net.0.proj"] = (m, d)
    mods.update({f"single_transformer_blocks.1.attn.{q}": (d, d)
                 for q in ("to_q", "to_k", "to_v")})
    sd = {}
    for j, (mod, (d_out, d_in)) in enumerate(mods.items()):
        sd[f"transformer.{mod}.lora_A.weight"] = rng.standard_normal((rank, d_in)).astype(
            np.float32)
        sd[f"transformer.{mod}.lora_B.weight"] = rng.standard_normal((d_out, rank)).astype(
            np.float32)
        if j % 3 == 0:
            sd[f"transformer.{mod}.alpha"] = np.float32(1.5 + j)
    return sd


def test_import_lora_factors_matches_jax(rng):
    sd = _lora_file(rng)
    want = jax_import_lora_factors(sd, FLUX_CFG, 0.75)
    got = import_lora_factors({k: torch.tensor(v) for k, v in sd.items()},
                              port_cfg(FLUX_CFG), 0.75)
    expected = {}
    for group, name, n_layers in (("double", "double_blocks", FLUX_CFG.num_double_layers),
                                  ("single", "single_blocks", FLUX_CFG.num_single_layers)):
        for target, f in want[group].items():
            for i in range(n_layers):
                expected[f"{name}.{i}.{target}"] = {k: f[k][i] for k in ("a", "b")}
    assert set(got) == set(expected) and len(got) == 8
    assert "double_blocks.0.img_mlp.fc1" not in got     # absent targets are omitted
    for path, f in expected.items():
        for k in ("a", "b"):
            assert got[path][k].dtype == torch.float32
            np.testing.assert_array_equal(got[path][k].numpy(), np.asarray(f[k]), err_msg=path)
    # the absent layers: a fresh A, B = 0
    assert not got["single_blocks.0.linear1"]["b"].any()
    assert got["single_blocks.0.linear1"]["a"].shape == (3, 16, 2)


def test_import_lora_factors_raises_as_jax(rng):
    base = _lora_file(rng)
    cases = {
        "outside the reference's peft target list": dict(
            base, **{"transformer.single_transformer_blocks.0.proj_mlp.lora_A.weight":
                     np.zeros((2, 16), np.float32)}),
        "only some sub-modules": {k: v for k, v in base.items()
                                  if "transformer_blocks.0.attn.to_k" not in k},
        "per-module ranks differ": dict(
            base, **{"transformer.transformer_blocks.0.attn.to_v.lora_A.weight":
                     np.zeros((3, 16), np.float32),
                     "transformer.transformer_blocks.0.attn.to_v.lora_B.weight":
                     np.zeros((16, 3), np.float32)}),
    }
    for message, sd in cases.items():
        with pytest.raises(ValueError, match=message):
            jax_import_lora_factors(sd, FLUX_CFG, 1.0)
        with pytest.raises(ValueError, match=message):
            import_lora_factors({k: torch.tensor(v) for k, v in sd.items()},
                                port_cfg(FLUX_CFG), 1.0)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _trained_state(optimizer, seed):
    g = torch.Generator().manual_seed(seed)
    lora = {"double_blocks.0.img_qkv": {"a": torch.nn.Parameter(torch.randn(3, 4, 2, generator=g)),
                                        "b": torch.nn.Parameter(torch.randn(3, 2, 4, generator=g))},
            "single_blocks.0.linear1": {"a": torch.nn.Parameter(torch.randn(4, 2, generator=g)),
                                        "b": torch.nn.Parameter(torch.randn(2, 4, generator=g))}}
    opt = TR.make_optimizer(TR.TrainConfig(optimizer=optimizer, learning_rate=0.1),
                            TR.lora_named_parameters(lora))
    for _ in range(2):
        for p in TR.lora_parameters(lora):
            p.grad = torch.randn(p.shape, generator=g)
        opt.step()
    return lora, opt


def _assert_trees_equal(a, b):
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b)
    elif isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _assert_trees_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_trees_equal(x, y)
    else:
        assert a == b


@pytest.mark.parametrize("optimizer", ["adamw", "prodigy", "adamw8bit"])
def test_checkpoint_round_trip_and_rotation(optimizer, tmp_path):
    ckpt = CheckpointManager(str(tmp_path / "checkpoints"), max_to_keep=2)
    states = {}
    for step in (2, 4, 6):
        lora, opt = _trained_state(optimizer, step)
        states[step] = CLI.train_state(lora, opt, step)
        ckpt.save(step, states[step], wait=step == 6)
    os.makedirs(tmp_path / "checkpoints" / ".8.partial")   # an interrupted write
    assert ckpt.all_steps() == [4, 6] and ckpt.latest_step() == 6
    _assert_trees_equal(ckpt.restore(), states[6])
    _assert_trees_equal(ckpt.restore(4), states[4])
    # the template puts each tensor on its device and dtype; structure is checked
    as_f64 = ckpt.restore(4, template=jax.tree_util.tree_map(
        lambda x: x.double() if isinstance(x, torch.Tensor) and x.is_floating_point() else x,
        states[4]))
    assert as_f64["lora"]["single_blocks.0.linear1"]["a"].dtype == torch.float64
    with pytest.raises(ValueError, match="keys"):
        ckpt.restore(4, template={"lora": {}, "opt_state": {}, "step": 0})
    # loading into fresh factors and optimizer continues bitwise
    lora, opt = _trained_state(optimizer, 99)
    assert CLI.load_train_state(lora, opt, ckpt.restore(6)) == 6
    _assert_trees_equal(CLI.train_state(lora, opt, 6), states[6])
    # --resume-from-checkpoint: 'latest', a step, a path ending in the step
    assert CLI.resume_step("latest", ckpt) is None
    assert CLI.resume_step("4", ckpt) == 4
    assert CLI.resume_step(str(tmp_path / "checkpoints" / "6") + "/", ckpt) == 6
    with pytest.raises(SystemExit, match=r"available: \[4, 6\]"):
        CLI.resume_step("2", ckpt)
    with pytest.raises(SystemExit, match="expects 'latest'"):
        CLI.resume_step("checkpoint-final", ckpt)
    assert CheckpointManager(str(tmp_path / "empty")).restore() is None


# ---------------------------------------------------------------------------
# the per-step noise stream over a resume: train_lora
# ---------------------------------------------------------------------------

def _byte_tokenizers(clip_len=77, t5_len=16):
    def clip_tok(prompt):
        body = [4 + b % 60 for b in prompt.encode()[: clip_len - 2]]
        return np.asarray([[2] + body + [3] * (clip_len - 1 - len(body))], np.int64)

    def t5_tok(prompt):
        body = [4 + b % 60 for b in prompt.encode()[: t5_len - 1]]
        return np.asarray([body + [3] + [0] * (t5_len - 1 - len(body))], np.int64)

    return clip_tok, t5_tok


def _tiny_models():
    g = torch.Generator().manual_seed(7)
    kw = dict(device="cpu", dtype=torch.float32, generator=g)
    return (FluxTransformer(port_cfg(FLUX_CFG), **kw), FluxVAE(port_cfg(VAE_CFG), **kw),
            CLIPTextModel(port_cfg(CLIP_CFG), **kw), T5Encoder(port_cfg(T5_CFG), **kw))


def test_train_lora_resume_continues_the_noise_stream(rng):
    batches = [{"pixel_values": rng.uniform(-1, 1, (1, 1, 32, 48, 3)).astype(np.float32),
                "mask": (rng.random((1, 1, 32, 48)) > 0.5).astype(np.float32),
                "prompts": ["the text"], "clip_prompts": ["a image"]} for _ in range(4)]
    clip_tok, t5_tok = _byte_tokenizers()
    tc = TR.TrainConfig(learning_rate=1e-2, lora_rank=2, lora_alpha=2.0,
                        compute_dtype="float32")
    kw = dict(tc=tc, clip_tokenize=clip_tok, t5_tokenize=t5_tok, seed=5, log_every=100)

    flux, vae, clip, t5 = _tiny_models()
    straight, hist = CLI.train_lora(flux, vae, clip, t5, iter(batches), steps=4, **kw)
    assert [h["step"] for h in hist] == [1, 2, 3, 4]

    state = {}
    CLI.train_lora(*_tiny_models(), iter(batches[:2]), steps=2, state=state, **kw)
    assert state["step"] == 2
    resumed, hist2 = CLI.train_lora(*_tiny_models(), iter(batches[2:]), steps=2, state=state,
                                    **kw)
    assert [h["step"] for h in hist2] == [3, 4] and state["step"] == 4
    for path, f in straight.items():
        for k in ("a", "b"):
            assert torch.equal(f[k], resumed[path][k]), path
    # the draws are a function of (seed, step): steps differ, seeds differ
    draw = lambda seed, step: torch.randn(4, generator=CLI.step_generator(seed, step, "cpu"))
    assert torch.equal(draw(5, 3), draw(5, 3))
    assert not torch.equal(draw(5, 3), draw(5, 4)) and not torch.equal(draw(5, 3), draw(6, 3))


# ---------------------------------------------------------------------------
# main() end to end
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    return write_tiny_checkpoint(str(tmp_path_factory.mktemp("tiny_ckpt")))


def _folder(root, sizes, rng):
    """A CombinedFolderDataset directory: one image per (h, w) in `sizes`,
    with a rectangle mask and a caption."""
    (root / "mask").mkdir(parents=True)
    for i, (h, w) in enumerate(sizes):
        Image.fromarray(rng.integers(0, 255, (h, w, 3), np.uint8)).save(root / f"s_{i}.png")
        m = np.zeros((h, w), np.uint8)
        m[h // 4:h // 2, w // 4:3 * w // 4] = 255
        Image.fromarray(m).save(root / "mask" / f"s_{i}_mask.png")
        (root / f"s_{i}.txt").write_text("the text\n")
    return str(root)


def _argv(checkpoint, data_dir, out_dir, *extra):
    return ["--model", checkpoint, "--data-dir", data_dir, "--resolution", "64",
            "--output-dir", str(out_dir), "--mode", "lora", "--lora-rank", "2",
            "--lora-alpha", "2", "--train-batch-size", "1", "--grad-accum", "1",
            "--max-sequence-length", "16", "--log-every", "1", "--seed", "3",
            "--device", "cpu", *extra]


def _log(out_dir):
    return [json.loads(x) for x in (out_dir / "train_log.jsonl").read_text().splitlines()]


def _export(out_dir):
    return load_safetensors_dir(str(out_dir / "pytorch_lora_weights.safetensors"))


@pytest.mark.parametrize("optimizer,lr", [("adamw", "1e-2"), ("prodigy", "1"),
                                          ("adamw8bit", "1e-2")])
def test_main_resume_is_bitwise_and_serves(optimizer, lr, checkpoint, tmp_path, rng, capsys):
    """4 steps straight against 2, then 2 more resumed from the checkpoint,
    on a one-image dataset at one resolution (so the data depend on neither
    thread order nor the dataset's RNG): the exported factors are equal
    bitwise. The export serves through from_pretrained(lora_path=...)."""
    data = _folder(tmp_path / "data", [(64, 64)], rng)
    opts = ["--optimizer", optimizer, "--learning-rate", lr, "--checkpointing-steps", "2"]
    straight = tmp_path / "straight"
    CLI.main(_argv(checkpoint, data, straight, *opts, "--max-train-steps", "4",
                   "--profile-steps", "1"))
    log = _log(straight)
    assert [e["step"] for e in log] == [1, 2, 3, 4]
    assert all(np.isfinite(e["loss"]) and np.isfinite(e["grad_norm"]) for e in log)
    assert os.listdir(straight / "checkpoints") and \
        CheckpointManager(str(straight / "checkpoints")).all_steps() == [2, 4]
    assert any(f.endswith(".json") for f in os.listdir(straight / "profile"))
    tracked = [json.loads(x) for x in (straight / "metrics.jsonl").read_text().splitlines()]
    assert [e["step"] for e in tracked] == [1, 2, 3, 4] and "loss" in tracked[0]

    split = tmp_path / "split"
    CLI.main(_argv(checkpoint, data, split, *opts, "--max-train-steps", "2"))
    CLI.main(_argv(checkpoint, data, split, *opts, "--max-train-steps", "4",
                   "--resume-from-checkpoint", "latest"))
    assert "resumed from step 2" in capsys.readouterr().out
    assert [e["step"] for e in _log(split)] == [1, 2, 3, 4]
    got, want = _export(split), _export(straight)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    # per double block 12 modules (the qkv groups as to_q, to_k, to_v each),
    # per single block 3
    a_keys = [k for k in want if k.endswith("lora_A.weight")]
    assert len(a_keys) == 12 * FLUX_CFG.num_double_layers + 3 * FLUX_CFG.num_single_layers
    assert all(want[k].shape[0] == 2 for k in a_keys)

    if optimizer == "adamw":
        tcfg = TC.PipelineConfig(num_inference_steps=2, max_sequence_length=16)
        img = Image.fromarray(rng.integers(0, 255, (48, 64, 3), np.uint8))
        mask = np.zeros((48, 64), np.uint8)
        mask[10:30, 8:40] = 255
        kw = dict(image=img, mask_image=Image.fromarray(mask), words=["OPEN"], height=48,
                  width=64, seed=4, output_type="np", dtype=torch.float32)
        base = FillPipeline.from_pretrained(checkpoint, dtype=torch.float32, pipe_cfg=tcfg,
                                            device="cpu")(**kw)
        tuned = FillPipeline.from_pretrained(checkpoint, lora_path=str(straight),
                                             dtype=torch.float32, pipe_cfg=tcfg,
                                             device="cpu")(**kw)
        assert np.isfinite(tuned).all() and np.abs(tuned - base).max() > 1e-4


def test_main_warm_start_exports_the_imported_lora(checkpoint, tmp_path, rng, capsys):
    """--pretrained-lora with no step taken: the export carries the file's
    deltas (alpha/r * B @ A) for every module the file has."""
    data = _folder(tmp_path / "data", [(64, 64)], rng)
    out = tmp_path / "out"
    src = str(tmp_path / "pretrained.safetensors")
    save_file({k: torch.tensor(v) for k, v in _lora_file(rng).items()}, src)
    CLI.main(_argv(checkpoint, data, out, "--max-train-steps", "0", "--pretrained-lora", src))
    assert "warm-started 4 LoRA targets" in capsys.readouterr().out
    sd, got = load_safetensors_dir(src), _export(out)
    for key in sd:
        if not key.endswith("lora_A.weight"):
            continue
        mod = key[: -len(".lora_A.weight")]
        delta = lambda d: (float(d.get(f"{mod}.alpha", d[key].shape[0])) / d[key].shape[0]
                           * d[f"{mod}.lora_B.weight"].float() @ d[key].float())
        torch.testing.assert_close(delta(got), delta(sd), rtol=1e-5, atol=1e-6)


def test_main_preemption_saves_and_resumes(checkpoint, tmp_path, rng):
    """SIGTERM mid-run: the step finishes, a checkpoint is saved, the log
    ends with {"preempted": true}, nothing is exported; resuming 'latest'
    continues from that step and then exports."""
    data = _folder(tmp_path / "data", [(64, 64)] * 4, rng)
    out = tmp_path / "out"
    argv = _argv(checkpoint, data, out, "--max-train-steps", "50",
                 "--checkpointing-steps", "100")
    log = out / "train_log.jsonl"

    def preempt_after_first_step():
        deadline = time.time() + 120
        while time.time() < deadline:
            if log.exists() and log.read_text().strip():
                os.kill(os.getpid(), signal.SIGTERM)
                return
            time.sleep(0.05)

    previous = signal.getsignal(signal.SIGTERM)
    threading.Thread(target=preempt_after_first_step, daemon=True).start()
    CLI.main(argv)
    assert signal.getsignal(signal.SIGTERM) == previous
    lines = _log(out)
    assert lines[-1].get("preempted") is True
    stop = lines[-1]["step"]
    assert 1 <= stop < 50
    assert CheckpointManager(str(out / "checkpoints")).all_steps() == [stop]
    assert not (out / "pytorch_lora_weights.safetensors").exists()

    argv[argv.index("--max-train-steps") + 1] = str(stop + 1)
    CLI.main(argv + ["--resume-from-checkpoint", "latest"])
    steps = [e["step"] for e in _log(out) if "loss" in e]
    assert steps == list(range(1, stop + 2))
    assert (out / "pytorch_lora_weights.safetensors").exists()


def test_main_exits_on_data_it_cannot_batch(checkpoint, tmp_path, rng):
    one = _folder(tmp_path / "one", [(64, 64)], rng)
    with pytest.raises(SystemExit, match="one optimizer step needs"):
        CLI.main(_argv(checkpoint, one, tmp_path / "o1", "--max-train-steps", "1",
                       "--grad-accum", "8"))
    # two samples, two buckets (64x64 and 32x64 at --bucket-quant 32), batch 2
    two = _folder(tmp_path / "two", [(64, 64), (64, 128)], rng)
    with pytest.raises(SystemExit, match="zero full batches"):
        CLI.main(_argv(checkpoint, two, tmp_path / "o2", "--max-train-steps", "1",
                       "--train-batch-size", "2", "--bucket-quant", "32"))


# each trainer choice beside the ROADMAP item that ports it; items 2, 4, 6b
# (training over the fsdp and tensor axes) and 7 (the loader's process
# mode) are ported
PORTED_CHOICES = (["--mode", "attn"], ["--mode", "all"], ["--optimizer", "adamw8bit"],
                  ["--use-8bit-adam"], ["--quantize-base", "nf4"], ["--mesh", "1,2,1"],
                  ["--mesh", "1,1,2"], ["--loader-procs", "2"])


@pytest.mark.parametrize("extra,item", [
    (["--mode", "attn"], "item 2"), (["--mode", "all"], "item 2"),
    (["--optimizer", "adamw8bit"], "item 2"), (["--use-8bit-adam"], "item 2"),
    (["--quantize-base", "nf4"], "item 4"), (["--mesh", "1,1,2"], "item 6b"),
    (["--loader-procs", "2"], "item 7")])
def test_main_refuses_unported_choices(extra, item, tmp_path):
    """Every choice once refused is ported now (`item` names the ROADMAP
    item that ported it): it passes the check and main() goes on to read
    the (absent) data, or, for a mesh of several ranks, to make its process
    group (absent in one process). The full-parameter modes with
    --quantize-base exit with the JAX trainer's own message."""
    argv = _argv("unused", str(tmp_path), tmp_path / "out") + extra
    if extra[0] == "--mode":
        with pytest.raises(SystemExit, match="--quantize-base requires --mode lora"):
            CLI.main(argv + ["--quantize-base", "weight_only"])
    assert extra in PORTED_CHOICES
    CLI.check_ported(CLI.parse_args(argv))
    with pytest.raises(RuntimeError if extra[0] == "--mesh" else FileNotFoundError,
                       match="torchrun" if extra[0] == "--mesh" else None):
        CLI.main(argv)


def test_main_trains_with_loader_processes(checkpoint, tmp_path, rng):
    """--loader-procs 1: two LoRA steps (two epochs of a one-sample dataset
    at one resolution, so the order and the samples are fixed) with the
    losses of the thread-mode run; no worker process and no file in shared
    memory is left when main() returns."""
    data = _folder(tmp_path / "data", [(64, 64)], rng)
    losses = {}
    for procs in ("0", "1"):
        out = tmp_path / f"procs{procs}"
        CLI.main(_argv(checkpoint, data, out, "--max-train-steps", "2", "--loader-procs", procs))
        losses[procs] = [e["loss"] for e in _log(out)]
    assert len(losses["1"]) == 2 and np.isfinite(losses["1"]).all()
    assert losses["1"] == losses["0"]
    assert not multiprocessing.active_children()
    assert not glob.glob(os.path.join(SHM_DIR, f"textflux-{os.getpid()}-*"))


def test_main_defaults_to_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a for a in _argv("unused", str(tmp_path), tmp_path / "out")
            if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CLI.main(argv)
    # the JAX parser's default --mode attn reaches the CUDA check too
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CLI.main(["--model", "m", "--data-dir", str(tmp_path), "--output-dir", "o"])
