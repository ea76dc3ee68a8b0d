"""The serving forward's CUDA graphs (``textflux_torch/models/graphs.py``)
on the CPU: when ``FluxTransformer.forward`` hands its body to the module's
``ForwardGraphs``, what tells keys apart, the eviction of the least recently
used key, the counters, the ``flux.graph`` span, the launch counters and
the weights' signature.

A CPU has no CUDA graphs, so where a test drives the runner it stands a
recorder in for ``ForwardGraphs._record`` whose replay runs the captured
function again on the static buffers: a replay then reads exactly what
was copied into them, as a graph does. The card's own graphs are held
against the eager forward in ``tests/test_torch_cuda_graphs.py``."""

import gc
import types
import weakref

import numpy as np
import pytest
import torch

from textflux_torch.config import FluxConfig, QwenImageConfig
from textflux_torch.io import quantize as Q
from textflux_torch.io.quantize import quantize_tree
from textflux_torch.models import graphs as G
from textflux_torch.models import qwen_image as QI
from textflux_torch.models import transformer as T
from textflux_torch.ops import flash_attention as FA
from textflux_torch.ops import packing
from textflux_torch.ops.rope import rope_tables
from textflux_torch.utils import tracking

CFG = FluxConfig(in_channels=12, out_channels=4, num_double_layers=2, num_single_layers=3,
                 num_heads=2, head_dim=16, joint_dim=24, pooled_dim=8, axes_dims_rope=(4, 6, 6))
# widths every quantise mode stores as itself (NF4 takes inputs in multiples of 128)
QCFG = FluxConfig(in_channels=128, out_channels=4, num_double_layers=1, num_single_layers=1,
                  num_heads=2, head_dim=64, joint_dim=128, pooled_dim=128,
                  axes_dims_rope=(16, 24, 24))
WRAPPERS = (FA.flash_attention_qk_norm_rope, FA.flash_attention, FA.flash_attention_lse,
            FA.flash_attention_dq, FA.flash_attention_dkv)


class _Replay:
    """What the recorder stands in for a graph with: replay() runs the
    captured function on the static buffers into the static output, and,
    as a graph runs no Python, leaves the wrappers' counters as they were."""

    def __init__(self, fn, static, out):
        self.fn, self.static, self.out = fn, static, out

    def replay(self):
        counts = [w.launches for w in WRAPPERS]
        self.out.copy_(self.fn(self.static))
        for w, n in zip(WRAPPERS, counts):
            w.launches = n


def _record(self, fn, static):
    out = fn(static)
    return _Replay(fn, static, out), out


@pytest.fixture()
def graphed(monkeypatch):
    """Forwards on the CPU engage the runner, with the recorder above."""
    monkeypatch.setattr(T, "_graphed", lambda x, **kw: True)
    monkeypatch.setattr(G.ForwardGraphs, "_record", _record)


@pytest.fixture(autouse=True)
def tracing_off():
    tracking.enable(False, capacity=tracking.CAPACITY)
    yield
    tracking.enable(False, capacity=tracking.CAPACITY)


def _model(cfg=CFG):
    return T.FluxTransformer(cfg, device="cpu",
                             generator=torch.Generator().manual_seed(0)).requires_grad_(False)


def _inputs(model, *, lat_hw=(4, 6), t_txt=5, b=1, seed=0, steps=3, dtype=torch.float32):
    """(img tokens, txt tokens, cos, sin, per-step mods) for one image."""
    cfg = model.cfg
    g = torch.Generator().manual_seed(seed)
    t_img = (lat_hw[0] // 2) * (lat_hw[1] // 2)
    img = torch.randn(b, t_img, cfg.in_channels, generator=g).to(dtype)
    txt = torch.randn(b, t_txt, cfg.joint_dim, generator=g).to(dtype)
    ids = np.concatenate([packing.text_ids(t_txt), packing.latent_image_ids(*lat_hw)], 0)
    cos, sin = (torch.as_tensor(x) for x in rope_tables(ids, cfg.axes_dims_rope))
    sig = torch.linspace(1.0, 0.2, steps)
    vec = T.flux_vec(model, sig.repeat_interleave(b), torch.full((steps * b,), 30.0),
                     torch.randn(steps * b, cfg.pooled_dim, generator=g), dtype)
    mods = T.flux_mods(model, vec)
    return img, txt, cos, sin, lambda i: T.step_mods(mods, i, b)


def _forward(model, img, txt, cos, sin, mods, **kw):
    return model(img, txt, None, None, None, cos, sin, attn_impl="plain", mods=mods, **kw)


def _eager(model, img, txt, cos, sin, mods, kv_len=None):
    return model._forward(img, txt, None, None, None, cos, sin, attn_impl="plain", remat=False,
                          kv_len=kv_len, mods=mods, mesh=None)


# ---------------------------------------------------------------------------
# when the graphs engage
# ---------------------------------------------------------------------------

CUDA_LIKE = types.SimpleNamespace(is_cuda=True)


@pytest.mark.parametrize("case", ["serving", "cpu", "grad", "mesh", "remat", "no_mods"])
def test_graphs_engage_only_on_a_serving_call(case):
    x = torch.zeros(1) if case == "cpu" else CUDA_LIKE
    kw = dict(remat=case == "remat", mods=None if case == "no_mods" else {},
              mesh=object() if case == "mesh" else None)
    with torch.set_grad_enabled(case == "grad"):
        assert T._graphed(x, **kw) is (case == "serving")


@pytest.mark.parametrize("mode", ["no_grad", "inference", "grad", "remat", "no_mods"])
def test_a_cpu_forward_never_touches_the_graphs(mode):
    model = _model()
    img, txt, cos, sin, step = _inputs(model)
    mods = None if mode == "no_mods" else step(0)
    ctx = {"no_grad": torch.no_grad(), "inference": torch.inference_mode(),
           "grad": torch.enable_grad(), "remat": torch.no_grad(),
           "no_mods": torch.no_grad()}[mode]
    with ctx:
        out = model(img, txt, torch.zeros(1, CFG.pooled_dim), torch.ones(1), torch.ones(1),
                    cos, sin, attn_impl="plain", mods=mods, remat=mode == "remat")
    assert out.shape == (1, img.shape[1], CFG.out_channels)
    assert model.graphs.calls == 0 and len(model.graphs) == 0


@pytest.mark.parametrize("mode", ["weight_only", "w8a8", "nf4", "mixed"])
def test_every_quantise_mode_takes_the_graphed_path(graphed, mode):
    """A quantised DiT is captured and replayed like a float one, NF4's
    linears included, and its replays give its eager forward."""
    model = _model(QCFG)
    quantize_tree(model, mode=mode, min_size=1)
    assert mode.replace("mixed", "nf4") in set(Q.quantized_linears(model).values())
    img, txt, cos, sin, step = _inputs(model)
    with torch.no_grad():
        for i in range(3):
            out = _forward(model, img, txt, cos, sin, step(i))
            assert torch.equal(out, _eager(model, img, txt, cos, sin, step(i)))
    assert (model.graphs.captures, model.graphs.replays) == (1, 1)


def test_the_nf4_codebook_is_made_once_a_device():
    """NF4's matmul reads one codebook tensor a device (a copy from the
    host a call would wait for the stream, and a graph cannot capture it):
    the codebook's values in float32, an ordinary tensor under inference
    mode too."""
    Q._codebook.cache_clear()
    with torch.inference_mode():
        code = Q._codebook(torch.device("cpu"))
    assert Q._codebook(torch.device("cpu")) is code and not code.is_inference()
    assert torch.equal(code, torch.tensor(Q.NF4_CODEBOOK, dtype=torch.float32))


# ---------------------------------------------------------------------------
# eager, capture, replay
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", [torch.no_grad, torch.inference_mode])
def test_a_key_runs_eagerly_then_captures_then_replays(graphed, mode):
    model = _model()
    img, txt, cos, sin, step = _inputs(model)
    with mode():
        outs = [_forward(model, img, txt, cos, sin, step(i)) for i in range(3)]
        refs = [_eager(model, img, txt, cos, sin, step(i)) for i in range(3)]
    g = model.graphs
    assert (g.calls, g.captures, g.replays, len(g)) == (3, 1, 1, 1)
    for out, ref in zip(outs, refs):
        assert torch.equal(out, ref)
    assert not any(torch.equal(outs[0], o) for o in outs[1:])   # each step's own mods


def test_a_replay_reads_the_new_inputs(graphed):
    """A second image of the same shape (other tokens, text, schedule)
    replays the first one's graph and matches its own eager forward: the
    static buffers take every input anew."""
    model = _model()
    a, b = _inputs(model, seed=1), _inputs(model, seed=2)
    with torch.no_grad():
        for i in range(2):
            _forward(model, *a[:4], a[4](i))
        captures = model.graphs.captures
        for i in range(3):
            out = _forward(model, *b[:4], b[4](i))
            assert torch.equal(out, _eager(model, *b[:4], b[4](i)))
    assert model.graphs.captures == captures == 1 and model.graphs.replays == 3


def test_the_output_is_never_the_graphs_buffer(graphed):
    """What the caller and a forward hook get is a copy: the next replay
    leaves it as it was."""
    model = _model()
    img, txt, cos, sin, step = _inputs(model)
    seen = []
    model.register_forward_hook(lambda m, args, out: seen.append((args[0], out)))
    with torch.no_grad():
        outs = [_forward(model, img, txt, cos, sin, step(i)) for i in range(3)]
        kept = [o.clone() for o in outs]
        _forward(model, img, txt, cos, sin, step(0))
    for out, k in zip(outs, kept):
        assert torch.equal(out, k)
    entry = next(iter(model.graphs._graphs.values()))
    assert all(o.data_ptr() != entry.out.data_ptr() for o in outs)
    assert [t is img for t, _ in seen] == [True] * 4
    assert all(o is out for (_, o), out in zip(seen, outs))


@pytest.mark.parametrize("change", ["shape", "batch", "text", "dtype", "kv_len", "tables"])
def test_keys_tell_inputs_apart(graphed, change):
    """Another token count, batch, text length, text dtype or kv_len is
    another graph; a canvas of the same shapes with other positions (its
    RoPE tables) is the same graph, its tables copied in."""
    model = _model()
    base = _inputs(model)
    other = {"shape": lambda: _inputs(model, lat_hw=(6, 6)),
             "batch": lambda: _inputs(model, b=2),
             "text": lambda: _inputs(model, t_txt=7),
             "dtype": lambda: (base[0], base[1].to(torch.bfloat16)) + base[2:],
             "kv_len": lambda: base,
             "tables": lambda: _inputs(model, lat_hw=(6, 4))}[change]()
    kv = dict(kv_len=base[0].shape[1] + 3) if change == "kv_len" else {}
    with torch.no_grad():
        for i in range(2):
            _forward(model, *base[:4], base[4](i))
            _forward(model, *other[:4], other[4](i), **kv)
        out = _forward(model, *other[:4], other[4](2), **kv)
        ref = _eager(model, *other[:4], other[4](2), **kv)
    assert torch.equal(out, ref)
    graphs = 1 if change == "tables" else 2
    assert (model.graphs.captures, len(model.graphs)) == (graphs, graphs)


@pytest.mark.parametrize("case", ["flux_canvas_again", "flux_new_canvas", "qwen_one_bucket"])
def test_the_key_is_derived_from_what_the_graph_takes(graphed, monkeypatch, case):
    """``graph_call`` keys a forward by its inputs' shapes, dtypes and
    devices and its other arguments: another request on a canvas already
    captured replays, a new canvas captures, and two Qwen-Image texts of
    one bucket (their own lengths reach the graph as a key-length tensor)
    share one graph. The ``flux.graph`` span names the key."""
    if case == "qwen_one_bucket":
        monkeypatch.setattr(QI, "_graphed", lambda x, **kw: True)
        model = QI.QwenImageTransformer(
            QwenImageConfig(in_channels=8, out_channels=8, num_double_layers=2, num_heads=2,
                            head_dim=16, joint_dim=12, axes_dims_rope=(4, 6, 6)),
            device="cpu", generator=torch.Generator().manual_seed(0)).requires_grad_(False)
        g = torch.Generator().manual_seed(1)
        img = torch.randn(1, 6, 8, generator=g)
        mods = T.flux_mods(model, QI.qwen_vec(model, torch.tensor([0.5]), torch.float32))
        cos, sin = (torch.as_tensor(t) for t in rope_tables(QI.rope_ids(2, 3, 64), (4, 6, 6)))

        def call(n, forward, txt):
            return forward(img, txt, cos, sin, attn_impl="plain", mods=mods,
                           kv_len=torch.tensor([6 + n], dtype=torch.int32))

        tracking.enable(True)
        with torch.no_grad():
            texts = {n: torch.nn.functional.pad(torch.randn(1, n, 12, generator=g),
                                                (0, 0, 0, 64 - n)) for n in (5, 9, 30, 64)}
            outs = [(call(n, model, t), call(n, model._forward, t)) for n, t in texts.items()]
        want = (1, 2, 1)
    else:
        model = _model()
        a, b = _inputs(model, seed=1), _inputs(model, seed=2)
        other = _inputs(model, lat_hw=(6, 4) if case == "flux_canvas_again" else (6, 6))
        tracking.enable(True)
        with torch.no_grad():
            outs = [(_forward(model, *x[:4], x[4](i)), _eager(model, *x[:4], x[4](i)))
                    for x in (a, b, other) for i in range(2)]
        want = (1, 4, 1) if case == "flux_canvas_again" else (2, 2, 2)
    for out, ref in outs:
        assert torch.equal(out, ref)
    g = model.graphs
    assert (g.captures, g.replays, len(g)) == want
    key = next(iter(g._graphs))
    assert key[0] == (img.shape if case == "qwen_one_bucket" else a[0].shape,
                      torch.float32, torch.device("cpu"))
    assert "attn_impl='plain'" in key and "mods" not in "".join(map(str, key))
    spans = [r.attrs for r in tracking.drain() if r.name == "flux.graph"]
    assert spans[0] == dict(key=G._describe(key), captured=True)
    kv_len = " 1:int32:cpu " if case == "qwen_one_bucket" else " kv_len=None"
    assert "attn_impl='plain'" in spans[0]["key"] and kv_len in spans[0]["key"]


def test_the_least_recently_used_key_goes_first(graphed, monkeypatch):
    monkeypatch.setattr(G, "GRAPH_KEYS", 2)
    model = _model()
    shapes = [(2, 2), (2, 4), (4, 4)]
    data = {hw: _inputs(model, lat_hw=hw) for hw in shapes}

    def call(hw, i=0):
        _forward(model, *data[hw][:4], data[hw][4](i))

    with torch.no_grad():
        for hw in shapes[:2]:
            call(hw), call(hw)             # eager, capture
        call(shapes[0])                    # (2, 2) is now the most recent
        call(shapes[2]), call(shapes[2])   # a third key evicts (2, 4)
        keys = [k[0][0][1] for k in model.graphs._graphs]   # the image tokens' count
        assert keys == [1, 4] and model.graphs.captures == 3
        # the evicted graph's own static buffers went with it
        assert sorted(k[1][1] for k in model.graphs._buffers if k[0] == 0) == [1, 4]
        call(shapes[0])
        assert model.graphs.captures == 3  # kept: replayed
        call(shapes[1])
        assert model.graphs.captures == 4  # evicted, still warm: captured again
    assert len(model.graphs) == 2


def test_new_weights_drop_the_graphs(graphed):
    """A graph reads the weights it was captured on: a replaced linear
    (here, quantised in place of the float one) drops every graph."""
    model = _model()
    img, txt, cos, sin, step = _inputs(model)
    with torch.no_grad():
        for i in range(3):
            _forward(model, img, txt, cos, sin, step(i))
        assert len(model.graphs) == 1
        model.single_blocks[0].linear2 = torch.nn.Linear(CFG.hidden_dim + CFG.mlp_dim,
                                                         CFG.hidden_dim)
        out = _forward(model, img, txt, cos, sin, step(0))
        assert len(model.graphs) == 0                      # dropped, and this call was eager
        assert torch.equal(out, _eager(model, img, txt, cos, sin, step(0)))


# ---------------------------------------------------------------------------
# the weights' signature
# ---------------------------------------------------------------------------

def test_the_signature_lists_the_weights_once():
    """The signature is every parameter's and buffer's address; the
    module is walked again only after some module registered a tensor or
    a submodule."""
    model = _model()
    runner = model.graphs
    walks = []
    modules = model.modules
    model.modules = lambda: walks.append(1) or modules()
    sig = runner.signature(model)
    assert sig == tuple(t.data_ptr() for m in modules()
                        for t in [*m._parameters.values(), *m._buffers.values()]
                        if t is not None)
    assert [runner.signature(model) for _ in range(3)] == [sig] * 3 and len(walks) == 1
    torch.nn.Linear(2, 2)                 # any module's registration lists them again
    assert runner.signature(model) == sig and len(walks) == 2


@pytest.mark.parametrize("change", ["moved", "replaced", "added", "buffer"])
def test_the_signature_sees_new_weights(change):
    """A tensor moved in place (``.data``, as ``.to`` does), a linear
    replaced, a parameter added (a LoRA factor) or a buffer set anew each
    change the signature."""
    model = _model()
    if change == "buffer":
        quantize_tree(model, mode="weight_only", min_size=1)
    runner = model.graphs
    sig = runner.signature(model)
    lin = model.single_blocks[0].linear2
    if change == "moved":
        lin.weight.data = lin.weight.data.clone()
    elif change == "replaced":
        model.single_blocks[0].linear2 = torch.nn.Linear(lin.in_features, lin.out_features)
    elif change == "added":
        lin.lora_a = torch.nn.Parameter(torch.zeros(lin.in_features, 2))
    else:
        lin.scale = lin.scale.clone()
    assert runner.signature(model) != sig


def test_the_signature_holds_no_weight():
    """A weight replaced after the signature listed it is freed at once:
    the list holds it weakly."""
    model = _model()
    model.graphs.signature(model)
    old = model.single_blocks[0].linear2.weight
    alive = [True]
    weakref.finalize(old, alive.clear)
    del old
    model.single_blocks[0].linear2 = torch.nn.Linear(CFG.hidden_dim + CFG.mlp_dim,
                                                     CFG.hidden_dim)
    gc.collect()
    assert alive == []


# ---------------------------------------------------------------------------
# counters, span, launch counters
# ---------------------------------------------------------------------------

def test_the_span_and_the_launch_credit(monkeypatch):
    """Each graphed call runs under ``flux.graph`` (``captured`` true at the
    capture). A replay credits the wrappers' counters nothing: they count
    the host's launches (the eager call and the capture), as no wrapper
    runs in a replay."""
    monkeypatch.setattr(G.ForwardGraphs, "_record", _record)
    runner = G.ForwardGraphs()
    x = torch.arange(4.0)

    def fn(inputs):
        FA.flash_attention_qk_norm_rope.launches += 3
        FA.flash_attention.launches += 1
        return inputs[0] * 2

    before = FA.flash_attention_qk_norm_rope.launches, FA.flash_attention.launches
    tracking.enable(True)
    for i in range(4):
        out = runner.run(("k", 1), "weights", fn, [x + i])
        assert torch.equal(out, (x + i) * 2)
    records = [r for r in tracking.drain() if r.name == "flux.graph"]
    assert [r.attrs for r in records] == [dict(key="k 1", captured=True),
                                          dict(key="k 1", captured=False),
                                          dict(key="k 1", captured=False)]
    assert (runner.calls, runner.captures, runner.replays) == (4, 1, 2)
    assert FA.flash_attention_qk_norm_rope.launches == before[0] + 6
    assert FA.flash_attention.launches == before[1] + 2


def test_static_buffers_are_shared_by_shape():
    """Keys share the static buffer of an input position while its shape
    and dtype agree (the text and the modulation vectors of one batch)."""
    runner = G.ForwardGraphs()
    txt = torch.zeros(1, 5, 3)
    a = runner._static(1, txt)
    assert runner._static(1, torch.ones(1, 5, 3)) is a
    assert runner._static(2, txt) is not a
    assert runner._static(1, torch.zeros(2, 5, 3)) is not a
    assert runner._static(1, txt.double()) is not a
    with torch.inference_mode():
        assert not runner._static(3, txt).is_inference()
