"""A whole run on the CPU at the tiny size, past the look for a card: sound,
it comes out correct; with the timed path broken underneath, correct comes
out false. A serving cell of batch 1 on one chip can have two of the
faults: a step that returns its state unchanged, and an answer altered
where it is produced (the velocity, the text embedding, the image). The
control, the reference in e4m3 in the program's place, fails too."""

import pytest
import torch

from conftest import tiny_args, tiny_cell


def test_sound_run_is_correct(run_module):
    line, code, checks = run_module.run_cell(tiny_cell(), tiny_args(), "cpu")
    assert code == 0 and '"correct": true' in line, checks


def _unchanged_step(monkeypatch):
    from textflux_torch.pipeline.fill import FillPipeline

    inner = FillPipeline._denoise_step
    monkeypatch.setattr(FillPipeline, "_denoise_step",
                        lambda self, lat, *a, **k: (inner(self, lat, *a, **k), lat)[1])


def _velocity_off(monkeypatch):
    import textflux_torch.pipeline.fill as fill

    inner = fill.flux_apply
    monkeypatch.setattr(fill, "flux_apply", lambda *a, **k: inner(*a, **k) * 1.1)


def _text_off(monkeypatch):
    import textflux_torch.pipeline.fill as fill

    inner = fill.t5_encode
    monkeypatch.setattr(fill, "t5_encode", lambda *a, **k: inner(*a, **k) * 1.1)


def _image_off(monkeypatch):
    from textflux_torch.pipeline.fill import FillPipeline

    inner = FillPipeline._decode
    monkeypatch.setattr(FillPipeline, "_decode",
                        lambda self, *a: (inner(self, *a).float() * 0.8).to(torch.bfloat16))


@pytest.mark.parametrize("fault", [_unchanged_step, _velocity_off, _text_off, _image_off],
                         ids=lambda f: f.__name__.strip("_"))
def test_fault_is_not_correct(run_module, monkeypatch, fault):
    fault(monkeypatch)
    line, code, checks = run_module.run_cell(tiny_cell(), tiny_args(), "cpu")
    assert code == 0 and '"correct": false' in line
    assert any(c["value"] > c["limit"] for c in checks)


def test_control_is_not_correct(run_module):
    cell = tiny_cell()
    out, code, _ = run_module.run_cell(cell, tiny_args(), "cpu", control=True)
    assert code == 0
    program, control = out["numbers"]["program"], out["numbers"]["control"]
    limits = cell["limits"]
    assert all(program[k] <= limits[k] for k in limits)
    assert any(control[k] > limits[k] for k in limits), control
