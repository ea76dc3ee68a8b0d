"""The Wan2.1-VACE cell's pieces on the CPU: its configuration uncut, its
traffic by seed, the token counts the cell's ``why`` states, and a whole
run of the tiny Wan cell under ``tiny_wan/``: sound, it comes out correct;
with a fault planted in the timed path (guidance that drops the negative,
a hint left out of the stream) or the e4m3 control in the program's place,
it does not."""

import argparse
import filecmp
import os

import pytest
import torch

from h100_bench import clips, flops_wan, harness

MIX = harness.load_json(harness.BENCH, "mixes", "video-edit-480p-cfg.json")
CFG = harness.load_json(harness.BENCH, "configs", "wan2.1-vace-14b.json")
TINY = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tiny_wan")


def tiny_cell(**limits):
    workload = harness.load_json(TINY, "workload.json")
    workload["limits"] = dict(workload["limits"], **limits)
    e2e = harness.load_json(harness.ROOT, "BENCHMARK.json")["end_to_end"]
    return harness.assemble("tiny_wan", workload, 1, harness.load_json(TINY, "config.json"),
                            harness.load_json(TINY, "mix.json"),
                            [dict(m, workloads=["tiny_wan"]) for m in e2e], [])


def tiny_args(seed=2 ** 31 + 9, seconds=0.05):
    return argparse.Namespace(workload="tiny_wan", seed=seed, seconds=seconds, trace=0)


def test_the_configuration_is_uncut():
    """40 + 8 blocks of 40 x 128 heads, FFN 13,824; UMT5-XXL at 256,384;
    the VAE at base 96; and the BENCHMARK.json entry that names the file."""
    entry = next(c for c in harness.load_json(harness.ROOT, "BENCHMARK.json")["configs"]
                 if c["name"] == "wan2.1-vace-14b")
    assert entry["file"] == "h100_bench/configs/wan2.1-vace-14b.json"
    assert CFG["reduced"] == entry["reduced"] == [] and CFG["source"] == entry["source"]
    dit, text, vae = CFG["wan_dit"], CFG["umt5"], CFG["wan_vae"]
    assert (dit["num_layers"], len(dit["vace_layers"]), dit["num_attention_heads"],
            dit["attention_head_dim"], dit["ffn_dim"], dit["text_dim"]) == (40, 8, 40, 128, 13824,
                                                                          4096)
    assert (text["num_layers"], text["d_model"], text["d_ff"], text["num_heads"],
            text["vocab_size"], text["model_type"]) == (24, 4096, 10240, 64, 256384, "umt5")
    assert (vae["base_dim"], vae["dim_mult"], vae["num_res_blocks"], vae["z_dim"]) == \
        (96, [1, 2, 4, 4], 2, 16)


def test_the_clips_and_their_tokens(tmp_path):
    """Two sizes in turn, 17 frames each: 9,880 and 8,400 video tokens; the
    same seed writes the same clips, another seed other content."""
    from h100_bench.drivers.serve_wan_closed_loop import canvas_hw

    mix = dict(MIX, pool=2)
    a = clips.make_clip_pool(mix, 2 ** 33 + 5, str(tmp_path / "a"))
    b = clips.make_clip_pool(mix, 2 ** 33 + 5, str(tmp_path / "b"))
    c = clips.make_clip_pool(mix, 17, str(tmp_path / "c"))
    assert [x.size for x in a] == [(832, 480), (480, 832)] == [x.size for x in c]
    assert [flops_wan.video_tokens(CFG, 17, *canvas_hw(x.size)) for x in a] == [9880, 8400]
    for x, y in zip(a, b):
        assert (x.words, x.noise_seed) == (y.words, y.noise_seed)
        fa, fb = clips.frame_files(x.scene), clips.frame_files(y.scene)
        assert len(fa) == 17 and all(filecmp.cmp(p, q, shallow=False) for p, q in zip(fa, fb))
    assert [x.words for x in a] != [x.words for x in c]


def test_a_sound_tiny_run_is_correct():
    run = harness.load_module(os.path.join(harness.BENCH, "run.py"), "h100_bench_run")
    _, code, checks = run.run_cell(tiny_cell(), tiny_args(), "cpu")
    assert code == 0
    assert all(c["value"] <= c["limit"] for c in checks), checks


@pytest.mark.parametrize("fault", ["no_negative", "dropped_hint"])
def test_a_planted_fault_is_not(monkeypatch, fault):
    from textflux_torch.models import wan
    from textflux_torch.ops import samplers

    if fault == "no_negative":
        monkeypatch.setattr(samplers, "cfg", lambda c, u, s: c)
    else:
        monkeypatch.setattr(wan, "HINT_SCALE", 0.0)
    run = harness.load_module(os.path.join(harness.BENCH, "run.py"), "h100_bench_run")
    _, code, checks = run.run_cell(tiny_cell(), tiny_args(), "cpu")
    failed = {c["name"] for c in checks if c["value"] > c["limit"]}
    assert failed, checks


def test_the_control_is_not():
    """The e4m3 control read by the same numbers fails the tiny limits."""
    run = harness.load_module(os.path.join(harness.BENCH, "run.py"), "h100_bench_run")
    out, _, _ = run.run_cell(tiny_cell(), tiny_args(), "cpu", control=True)
    limits = harness.load_json(TINY, "workload.json")["limits"]
    ctl = out["numbers"]["control"]
    assert any(ctl[k] > v for k, v in limits.items()), ctl
    assert torch.isfinite(torch.tensor(out["numbers"]["program"]["stage_rel"]))
