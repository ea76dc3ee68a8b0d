"""The serving forward's CUDA graphs against the eager forward, on the card.

The full-width FLUX.1-Fill DiT (19 + 38 blocks, 24 x 128 heads) with seeded
weights, in bf16 and in each ``--quantize-mode`` (``weight_only`` and
``w8a8`` int8 codes, w8a8 with int8 activations too; ``nf4``; ``mixed``),
on the four canvases of a 512-px edit (joint 1,216 / 1,328 / 1,408 / 1,664
tokens with the text): final latents bitwise equal to the eager forward's
(the graph replays the same kernels on the same inputs), a second request
of a shape replayed without a capture, ``generate_batch`` at four, a
padded sequence (kv_len < joint), what a forward hook sees, the launch
counter and the profiler's view of a replay, eight keys up to the demo's
largest canvas (2048 x 1024, joint 8,704), and the memory the graphs hold.
Like ``tests/test_torch_cuda.py`` these carry the ``cuda`` marker and skip
without a CUDA device:

    python -m pytest tests/test_torch_cuda_graphs.py -m cuda -q -s --noconftest

``-s`` shows, per mode, a ``graphs`` JSON line (the private pool's bytes
after each edit canvas's capture, and what each capture added to the pool
and to the bytes allocated outside it) and a ``graphs eight`` line (the
pool, its free bytes and the allocator's reserved bytes after each of the
eight keys' captures, captured from the smallest canvas up and then again
from the largest down).
"""

import dataclasses
import gc
import json
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from textflux_torch.config import flux_fill_config, flux_vae_config
from textflux_torch.io.quantize import quantize_tree
from textflux_torch.models import transformer as T
from textflux_torch.models.transformer import FluxTransformer
from textflux_torch.models.vae import FluxVAE
from textflux_torch.ops import flash_attention as FA
from textflux_torch.pipeline.fill import FillPipeline

pytestmark = pytest.mark.cuda

# (height, width) of the edit-512 canvases, strip included: 704, 816, 896
# and 1,152 image tokens beside the 512 of the text
CANVASES = ((352, 512), (544, 384), (448, 512), (576, 512))
# eight keys, smallest first: the edit canvases, 512 and 768 squares, a
# 1024 square, and the demo's multiline canvas of a 1024-px scene
EIGHT = ((352, 512), (544, 384), (448, 512), (512, 512), (576, 512), (768, 768),
         (1024, 1024), (1024, 2048))
STEPS = 4            # step 0 eager, 1 captured, 2-3 replayed on a key's first request
PER_STEP = 19 + 38   # fused attention calls a step


def _request(seed, hw):
    """A canvas, its mask and text embeddings, drawn from `seed`."""
    rng = np.random.default_rng(seed)
    h, w = hw
    image = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    mask = np.zeros((h, w), np.uint8)
    mask[h // 3:2 * h // 3, w // 4:3 * w // 4] = 255
    g = torch.Generator().manual_seed(seed)
    embeds = (torch.randn(1, 768, generator=g), torch.randn(1, 512, 4096, generator=g))
    return dict(image=image, mask_image=mask, text_embeds=embeds, seed=seed)


@pytest.fixture(scope="module", params=["bf16", "weight_only", "w8a8", "nf4", "mixed"])
def pipe(request):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs and the fused kernel have no CPU mode)")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    flux = FluxTransformer(flux_fill_config(), device=dev, dtype=torch.bfloat16,
                           generator=gen).requires_grad_(False)
    if request.param != "bf16":
        quantize_tree(flux, mode=request.param)
    vae = FluxVAE(flux_vae_config(), device=dev, dtype=torch.bfloat16,
                  generator=gen).requires_grad_(False)
    p = FillPipeline(flux=flux, vae=vae, device=dev)
    assert p.attn_impl == "fused"
    p.mode = request.param
    yield p
    del p, flux, vae
    gc.collect()
    torch.cuda.empty_cache()


def _eager(monkeypatch):
    monkeypatch.setattr(T, "_graphed", lambda x, **kw: False)


def _latents(pipe, req, **kw):
    out = pipe(**req, num_inference_steps=STEPS, output_type="latent", **kw)
    torch.cuda.synchronize()
    return out


def _pool_segments(graphs) -> list:
    if graphs._pool is None:
        return []
    return [seg for seg in torch.cuda.memory_snapshot()
            if tuple(seg.get("segment_pool_id", ())) == tuple(graphs._pool)]


def _pool_bytes(graphs) -> int:
    """Bytes the allocator has reserved in the graphs' private pool."""
    return sum(seg["total_size"] for seg in _pool_segments(graphs))


def _pool_free(graphs) -> int:
    """Bytes of the pool that no tensor holds (the captures' freed blocks)."""
    return sum(b["size"] for seg in _pool_segments(graphs) for b in seg["blocks"]
               if b["state"] == "inactive")


def _hooked(pipe, fn):
    """fn() with a forward hook on the DiT that keeps each step's tokens and
    velocity, as the benchmark's recorder does."""
    seen = []
    handle = pipe.flux.register_forward_hook(
        lambda m, args, out: seen.append((args[0].clone(), out.clone())))
    try:
        return fn(), seen
    finally:
        handle.remove()


def test_graphed_requests_match_the_eager_forward(pipe, monkeypatch):
    """Each canvas: a first request (eager, captured, replayed) and a
    second one of other text and seed (replayed alone) give the eager
    forward's latents to the bit, and so does every step a hook sees."""
    graphs = pipe.flux.graphs
    log = []
    for i, hw in enumerate(CANVASES):
        first, second = _request(10 + i, hw), _request(20 + i, hw)
        with monkeypatch.context() as m:
            _eager(m)
            ref_first, ref_seen = _hooked(pipe, lambda: _latents(pipe, first))
            ref_second = _latents(pipe, second)
        before = _pool_bytes(graphs), torch.cuda.memory_allocated()
        captures = graphs.captures
        out_first, seen = _hooked(pipe, lambda: _latents(pipe, first))
        log.append(dict(joint=pipe.last_joint_seq, pool=_pool_bytes(graphs),
                        pool_added=_pool_bytes(graphs) - before[0],
                        allocated_added=torch.cuda.memory_allocated() - before[1]))
        assert graphs.captures == captures + 1
        assert torch.equal(out_first, ref_first), hw
        assert len(seen) == len(ref_seen) == STEPS
        for (x, v), (rx, rv) in zip(seen, ref_seen):
            assert torch.equal(x, rx) and torch.equal(v, rv), hw
        replays = graphs.replays
        out_second = _latents(pipe, second)
        assert graphs.captures == captures + 1 and graphs.replays == replays + STEPS
        assert torch.equal(out_second, ref_second), hw
    assert [r["joint"] for r in log] == [1216, 1328, 1408, 1664]
    assert len(graphs) == len(CANVASES)
    t0 = time.perf_counter()
    for _ in range(100):
        graphs.signature(pipe.flux)
    print("graphs " + json.dumps(dict(mode=pipe.mode, captures=log,
                                      reserved=torch.cuda.memory_reserved(),
                                      allocated=torch.cuda.memory_allocated(),
                                      signature_ms=10 * (time.perf_counter() - t0))))


def test_generate_batch_and_a_padded_sequence(pipe, monkeypatch):
    """generate_batch at B = 4 (its own key), and a request padded to a
    multiple of 256 tokens (kv_len < joint): graphed as eager, to the bit."""
    hw = CANVASES[2]
    reqs = [_request(30 + i, hw) for i in range(4)]
    batch = dict(images=[r["image"] for r in reqs], masks=[r["mask_image"] for r in reqs],
                 words_list=[["a"]] * 4, height=hw[0], width=hw[1], seeds=[30, 31, 32, 33],
                 num_inference_steps=STEPS,
                 text_embeds=tuple(torch.cat([r["text_embeds"][k] for r in reqs])
                                   for k in (0, 1)))
    padded = _request(40, hw)
    with monkeypatch.context() as m:
        _eager(m)
        ref_batch, ref_seen = _hooked(pipe, lambda: pipe.generate_batch(**batch))
        ref_pad = _latents(pipe, padded, seq_pad_multiple=256)
    for _ in range(2):   # the second time replays from the first step
        out_batch, seen = _hooked(pipe, lambda: pipe.generate_batch(**batch))
        for a, b in zip(out_batch, ref_batch):
            assert np.array_equal(np.asarray(a), np.asarray(b))
        for (x, v), (rx, rv) in zip(seen, ref_seen):
            assert x.shape[0] == 4 and torch.equal(x, rx) and torch.equal(v, rv)
        assert torch.equal(_latents(pipe, padded, seq_pad_multiple=256), ref_pad)
    assert pipe.last_joint_seq == 1536     # 896 image tokens padded to 1,024


def test_a_replay_counts_its_launches_and_the_profiler_sees_them(pipe):
    """A request served by replays alone: the fused wrapper, which no
    replay runs, counts no launch, and the profiler, started after the
    capture, sees each kernel inside the graph, 57 a step."""
    req = _request(50, CANVASES[2])
    for _ in range(2):
        _latents(pipe, req)       # the key seen, captured
    launches, replays = FA.flash_attention_qk_norm_rope.launches, pipe.flux.graphs.replays
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _latents(pipe, req)
    assert pipe.flux.graphs.replays == replays + STEPS
    assert FA.flash_attention_qk_norm_rope.launches == launches
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.device_type().name == "CUDA"]
    for kernel in ("norm_rope_kernel", "flash_fwd_sm90_kernel"):
        assert sum(kernel in n for n in names) == PER_STEP * STEPS, kernel


def test_the_graphs_go_with_the_module(pipe):
    """Deleting the DiT frees its graphs and their pool: a module built,
    graphed and dropped leaves the allocator where it was."""
    cfg = dataclasses.replace(flux_fill_config(), num_double_layers=2, num_single_layers=4)
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    flux = FluxTransformer(cfg, device="cuda", dtype=torch.bfloat16).requires_grad_(False)
    small = FillPipeline(flux=flux, vae=pipe.vae, device="cuda")
    _latents(small, _request(60, CANVASES[0]))
    assert flux.graphs.captures == 1 and flux.graphs.replays == STEPS - 2
    del small, flux
    gc.collect()
    torch.cuda.empty_cache()
    after = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    print("graphs freed " + json.dumps(dict(mode=pipe.mode, before=base, after=after)))
    assert after[0] <= base[0] + 64 * 2 ** 20   # at most a cuBLAS workspace more


def test_eight_keys_and_the_largest_canvas(pipe, monkeypatch):
    """GRAPH_KEYS canvases, the demo's largest (joint 8,704) among them, each
    graphed as eager to the bit and none evicted; then the same keys
    captured from the largest down, to show what the order does to the
    pool (printed, not held to a bound)."""
    graphs = pipe.flux.graphs
    assert len(EIGHT) == graphs.capacity
    reqs = [_request(70 + i, hw) for i, hw in enumerate(EIGHT)]
    report = {}
    for order, keys in (("up", list(range(len(EIGHT)))), ("down", list(range(len(EIGHT)))[::-1])):
        graphs.clear()
        gc.collect()
        torch.cuda.empty_cache()
        log = []
        for i in keys:
            if order == "up":
                with monkeypatch.context() as m:
                    _eager(m)
                    ref = _latents(pipe, reqs[i])
            out = _latents(pipe, reqs[i])
            if order == "up":
                assert torch.equal(out, ref), EIGHT[i]
            log.append(dict(joint=pipe.last_joint_seq, pool=_pool_bytes(graphs),
                            pool_free=_pool_free(graphs),
                            reserved=torch.cuda.memory_reserved()))
        assert len(graphs) == len(EIGHT) and max(r["joint"] for r in log) == 8704
        report[order] = log
    print("graphs eight " + json.dumps(dict(mode=pipe.mode, **report)))
