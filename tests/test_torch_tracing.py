"""The port's spans (``textflux_torch/utils/tracking.py``) on the CPU: free
and invisible while tracing is off, parents, requests, attributes and the
bounded buffer while it is on, the spans a tiny FillPipeline call and a
tiny training step make, and the clock they share with the profiler's own
events under ``profile_trace``."""

import os
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from textflux_torch.pipeline.fill import FillPipeline
from textflux_torch.utils import tracking

from test_torch_pipeline import EXAMPLE, _byte_tokenizers, _fixture_inputs, _tiny_8x_pipeline

MS = 1_000_000


@pytest.fixture(autouse=True)
def tracing_off():
    """Every test starts and ends with tracing off and an empty buffer."""
    tracking.enable(False, capacity=tracking.CAPACITY)
    yield
    tracking.enable(False, capacity=tracking.CAPACITY)


def _names(records):
    return Counter(r.name for r in records)


def _profiled_names(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return {e.name() for e in prof.profiler.kineto_results.events()}


def test_off_is_one_shared_object_that_records_nothing(monkeypatch):
    opened = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: opened.append(name) or tracking._OFF)
    a, b = tracking.span("x"), tracking.span("y", step=3)
    assert a is b is tracking._OFF
    with tracking.span("x") as s:
        s.set(done=True)
    assert tracking.drain() == [] and opened == []


@pytest.mark.parametrize("on", [False, True], ids=["off", "on"])
def test_a_profiler_beside_the_spans_sees_no_span_names(on):
    """Only profile_trace puts spans into a profile: the benchmark's own
    profiler sees none, traced or not."""
    tracking.enable(on)

    def work():
        with tracking.span("outer.span"):
            with tracking.span("inner.span"):
                torch.ones(4) + 1

    names = _profiled_names(work)
    assert "aten::add" in names and not {"outer.span", "inner.span"} & names
    assert len(tracking.drain()) == (2 if on else 0)


def test_parents_requests_and_attributes():
    tracking.enable(True)
    with tracking.span("root", kind="a") as root:
        with tracking.span("child", step=1):
            with tracking.span("grandchild"):
                pass
        root.set(late=2)
    with tracking.span("second"):
        pass
    recs = {r.name: r for r in tracking.drain()}
    assert tracking.drain() == []
    r, c, g, s = recs["root"], recs["child"], recs["grandchild"], recs["second"]
    assert r.parent is None and r.request == r.id and r.attrs == {"kind": "a", "late": 2}
    assert c.parent == r.id and g.parent == c.id and c.attrs == {"step": 1}
    assert c.request == g.request == r.id
    assert s.parent is None and s.request == s.id != r.request
    assert r.start_ns <= c.start_ns <= g.start_ns <= g.end_ns <= c.end_ns <= r.end_ns


def test_the_bound_drops_the_oldest_and_counts_them():
    tracking.enable(True, capacity=3)
    for i in range(5):
        with tracking.span(f"s{i}"):
            pass
    assert tracking.dropped() == 2
    assert [r.name for r in tracking.drain()] == ["s2", "s3", "s4"]
    assert tracking.dropped() == 0


def test_enable_reports_the_previous_state():
    assert tracking.enable(True) is False
    assert tracking.enable(False) is True
    with tracking.span("after"):
        pass
    assert tracking.drain() == []


@pytest.mark.parametrize("attn_impl", ["plain", "fused"])
def test_fill_call_spans_and_an_unchanged_image(attn_impl):
    base = _tiny_8x_pipeline()
    pipe = FillPipeline(flux=base.flux, vae=base.vae, clip=base.clip, t5=base.t5,
                        clip_tokenize=base.clip_tokenize, t5_tokenize=base.t5_tokenize,
                        attn_impl=attn_impl, device="cpu")
    img, mask = _fixture_inputs()
    steps = 2
    kw = dict(image=img, mask_image=mask, words=["OPEN"], height=64, width=96, seed=3,
              num_inference_steps=steps, dtype=torch.float32, output_type="np")
    off = pipe(**kw)
    assert tracking.drain() == []
    tracking.enable(True)
    on = pipe(**kw)
    tracking.enable(False)
    recs = tracking.drain()
    np.testing.assert_array_equal(on, off)

    cfg = pipe.flux_cfg
    blocks = cfg.num_double_layers + cfg.num_single_layers
    n = _names(recs)
    assert n["fill.call"] == 1 and n["fill.denoise_step"] == steps
    assert n["sampler.update"] == steps and n["fill.postprocess"] == 1
    assert n["flux.double_block"] == steps * cfg.num_double_layers
    assert n["flux.single_block"] == steps * cfg.num_single_layers
    assert n["attn.fused"] == (steps * blocks if attn_impl == "fused" else 0)
    for name in ("text.clip", "text.t5", "vae.encode", "fill.schedule", "vae.decode"):
        assert n[name] == 1, name

    call = next(r for r in recs if r.name == "fill.call")
    assert call.parent is None and all(r.request == call.id for r in recs)
    assert call.attrs == {"steps": steps, "height": 64, "width": 96,
                          "joint": pipe.last_joint_seq}
    by_id = {r.id: r for r in recs}
    step_spans = sorted((r for r in recs if r.name == "fill.denoise_step"),
                        key=lambda r: r.start_ns)
    assert [r.attrs["step"] for r in step_spans] == list(range(steps))
    for r in recs:
        if r.name in ("flux.double_block", "flux.single_block", "sampler.update"):
            assert by_id[r.parent].name == "fill.denoise_step"
    assert next(r for r in recs if r.name == "vae.encode").attrs == {"tiled": False}


def test_run_inference_is_one_request():
    from textflux_torch.cli.run_inference import run

    pipe = _tiny_8x_pipeline()
    paths = [os.path.join(EXAMPLE, sub, name) for sub, name in
             (("ori", "ori_0001.png"), ("mask", "mask_0001.png"), ("txt", "words_0001.txt"))]
    tracking.enable(True)
    run(pipe, *paths, steps=1, seed=0, device="cpu")
    recs = tracking.drain()
    roots = [r for r in recs if r.parent is None]
    assert [r.name for r in roots] == ["edit.request"]
    by_id = {r.id: r for r in recs}
    for name in ("edit.render", "fill.call", "edit.crop"):
        assert by_id[next(r for r in recs if r.name == name).parent].name == "edit.request"


def test_spans_share_the_profilers_clock(tmp_path):
    """Under profile_trace each span is also a record_function range, and
    the two agree to well under a millisecond: time.time_ns() is the
    profiler's clock."""
    tracking.enable(True)
    with tracking.profile_trace(str(tmp_path)) as prof:
        with tracking.span("clock.warm"):     # the first range costs ~1 ms to open
            pass
        for i in range(3):
            with tracking.span("clock.outer", i=i):
                x = torch.randn(64, 64)
                with tracking.span("clock.inner"):
                    (x @ x).sum()
    assert tracking.enable(False) is True        # restored to what it was
    recs = [r for r in tracking.drain() if r.name != "clock.warm"]
    events = {}
    for e in prof.profiler.kineto_results.events():
        events.setdefault(e.name(), []).append(e)
    assert len(recs) == 6
    assert len(events["clock.outer"]) == len(events["clock.inner"]) == 3
    for r in recs:
        ev = min(events[r.name], key=lambda e: abs(e.start_ns() - r.start_ns))
        assert abs(ev.start_ns() - r.start_ns) < MS and abs(ev.end_ns() - r.end_ns) < MS
    assert list(tmp_path.glob("trace_*.json"))


def test_profile_trace_restores_tracing_off(tmp_path):
    with tracking.profile_trace(str(tmp_path)):
        with tracking.span("inside"):
            pass
    with tracking.span("outside"):
        pass
    assert [r.name for r in tracking.drain()] == ["inside"]


def test_training_spans_once_per_step_and_micro_batch():
    from textflux_torch.cli import train as CLI
    from textflux_torch.training import train as TR

    pipe = _tiny_8x_pipeline()
    rng = np.random.default_rng(0)
    accum, steps = 2, 2
    batches = [{"pixel_values": rng.uniform(-1, 1, (accum, 1, 64, 64, 3)).astype(np.float32),
                "mask": (rng.random((accum, 1, 64, 64)) > 0.5).astype(np.float32),
                "prompts": ["the text"] * accum, "clip_prompts": ["a image"] * accum}
               for _ in range(steps)]
    clip_tok, t5_tok = _byte_tokenizers()
    tc = TR.TrainConfig(learning_rate=1e-2, lora_rank=2, lora_alpha=2.0,
                        compute_dtype="float32")
    tracking.enable(True)
    CLI.train_lora(pipe.flux, pipe.vae, pipe.clip, pipe.t5, iter(batches), tc=tc,
                   clip_tokenize=clip_tok, t5_tokenize=t5_tok, steps=steps, log_every=100)
    recs = tracking.drain()
    n = _names(recs)
    for name in ("train.step", "train.data_wait", "train.text_encode", "train.update"):
        assert n[name] == steps, name
    assert n["train.forward"] == n["train.backward"] == steps * accum
    roots = [r for r in recs if r.parent is None]
    assert {r.name for r in roots} == {"train.step"}
    assert sorted(r.attrs["step"] for r in roots) == list(range(steps))
    # remat: each block runs once in the forward and again, as a span of its
    # own, in the backward (on the CPU the engine runs it on this thread)
    assert tc.remat
    by_id = {r.id: r for r in recs}
    per = steps * accum * pipe.flux_cfg.num_double_layers
    within = Counter(by_id[r.parent].name for r in recs if r.name == "flux.double_block")
    assert within == {"train.forward": per, "train.backward": per}
