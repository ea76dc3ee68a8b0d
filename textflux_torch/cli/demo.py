"""Gradio demos (the reference's demo.py and demo_beta.py).

The port of ``textflux_tpu/cli/demo.py``. The UI callbacks are pure
functions over a FillPipeline, so they run and test without gradio (which
is installed neither in the test environment nor on the GPU machine: the UI
layer imports it lazily, and ``check_gradio`` fails fast with the JAX
package's messages).

  demo_custom           — original demo: sketch/mask -> always multi-line
                          glyph-in-region conditioning (demo.py:399-495)
  demo_normal           — pre-combined image+mask inputs (demo.py:130)
  demo_custom_beta      — beta: single-line strip when one line; multi-line as
                          stacked strips of height min(w//6, h/num_texts)
                          (demo_beta.py:235-320)

  python -m textflux_torch.cli.demo --model CKPT [--beta] [--port 7860]
      [--quantize-mode weight_only|w8a8|nf4|mixed] [--device cuda|cpu]

On a mesh (``torchrun --nproc-per-node dp*tp -m textflux_torch.cli.demo
--mesh dp,1,tp ...``) rank 0 builds the UI; the other ranks follow: each
callback's name and inputs reach them by ``broadcast_object_list`` and every
rank runs the same callback, so the tensor-parallel DiT's collectives line
up (``lead`` / ``follow``). A follower waits for the next click inside a
collective, so the process group of a demo is made with a long timeout
(``DEMO_IDLE``).
"""

from __future__ import annotations

from datetime import timedelta
from typing import Callable, Dict, List, Optional

import numpy as np
from PIL import Image

from textflux_torch.pipeline.prompts import build_prompts, read_words
from textflux_torch.rendering import (
    SINGLE_LINE_STRIP_RATIO,
    draw_glyph_beta,
    concat_multiline,
    concat_singleline,
    crop_multiline_result,
    crop_singleline_result,
    extract_mask,
    load_font,
    render_glyph_multi,
)


def _snap32(img: Image.Image) -> Image.Image:
    from textflux_torch.pipeline.image_processor import snap_to_multiple

    return img.resize(snap_to_multiple(*img.size))


def _run_pipe(pipe, image, mask, words, steps, guidance, seed, sampler="overshoot",
              overshoot_c=None):
    image, mask = _snap32(image), _snap32(mask)
    prompt, prompt_2 = build_prompts(words)
    return pipe(
        image=image, mask_image=mask, prompt=prompt, prompt_2=prompt_2,
        width=image.size[0], height=image.size[1],
        num_inference_steps=steps, guidance_scale=guidance, seed=seed,
        sampler=sampler, overshoot_c=overshoot_c,
    )[0]


def demo_custom(pipe, original: Image.Image, drawn, words_text: str,
                steps: int = 30, guidance: float = 30.0, seed: int = 42,
                sampler: str = "overshoot", overshoot_c: Optional[float] = None,
                font=None):
    """Custom mode: extract the sketch mask, render per-region glyphs, fill."""
    words = read_words(words_text)
    mask = extract_mask(original, drawn)
    rendered = render_glyph_multi(original, mask, words, font=font)
    combined, combined_mask, direction = concat_multiline(original, mask, rendered)
    result = _run_pipe(pipe, combined, combined_mask, words, steps, guidance, seed,
                       sampler, overshoot_c)
    return crop_multiline_result(result, direction), result, rendered


def demo_normal(pipe, combined: Image.Image, combined_mask: Image.Image,
                words_text: str, steps: int = 30, guidance: float = 30.0,
                seed: int = 42, sampler: str = "overshoot",
                overshoot_c: Optional[float] = None):
    """Normal mode: inputs are already concatenated."""
    words = read_words(words_text)
    return _run_pipe(pipe, combined, combined_mask, words, steps, guidance, seed,
                     sampler, overshoot_c)


def _stacked_strips(original: Image.Image, words: List[str], font) -> Image.Image:
    """Beta multi-line: one strip per line, each min(w//6, h/num_texts) tall."""
    w, h = original.size
    # reference clamps to >=1 (demo_beta.py:281-282): many lines on a short
    # image would otherwise yield zero-height strips = no glyph conditioning
    strip_h = max(1, int(min(w // 6, h / max(len(words), 1))))
    strips = [
        np.array(draw_glyph_beta(font, t, w, strip_h).convert("RGB"))
        for t in words
    ]
    return Image.fromarray(np.vstack(strips))


def demo_custom_beta(pipe, original: Image.Image, drawn, words_text: str,
                     steps: int = 30, guidance: float = 30.0, seed: int = 42,
                     sampler: str = "overshoot", overshoot_c: Optional[float] = None,
                     font=None):
    """Beta custom mode: strip-based conditioning, dispatch on line count."""
    words = read_words(words_text)
    mask = extract_mask(original, drawn)
    font = font or load_font(size=60)

    if len(words) <= 1:
        w = original.size[0]
        strip = draw_glyph_beta(font, " ".join(words), w,
                                int(w * SINGLE_LINE_STRIP_RATIO))
    else:
        strip = _stacked_strips(original, words, font)
    combined, combined_mask, strip_h = concat_singleline(original, mask, strip)
    result = _run_pipe(pipe, combined, combined_mask, words, steps, guidance, seed,
                       sampler, overshoot_c)
    return crop_singleline_result(result, original.size[1], strip_h), result, strip


# The Blocks layer targets gradio 3.x (pinned: 3.50.1, the reference's
# version — demo.py uses the 3.x sketch-tool API `gr.Image(tool="sketch")`,
# removed in gradio 4). The callbacks below are version-independent.
SUPPORTED_GRADIO = "3.50.1"


def _custom_click(pipe, custom_fn):
    """The Custom-tab click callback build_ui wires: (sketch dict, words,
    steps, guidance, seed, overshoot_c) -> cropped result."""
    def cb(img, w, s, g, sd, c):
        return custom_fn(pipe, img["image"], img, w, int(s), float(g),
                         int(sd), overshoot_c=float(c))[0]
    return cb


def _normal_click(pipe):
    """The Normal-tab click callback: (combined, mask, words) -> result."""
    def cb(a, b, w):
        return demo_normal(pipe, a, b, w)
    return cb


def ui_callbacks(pipe, *, beta: bool = False) -> Dict[str, Callable]:
    """The UI's click callbacks by name."""
    return {"custom": _custom_click(pipe, demo_custom_beta if beta else demo_custom),
            "normal": _normal_click(pipe)}


# how long a follower rank may wait for the next click (the process
# group's timeout, which bounds a waiting collective)
DEMO_IDLE = timedelta(days=7)


def lead(callbacks: Dict[str, Callable]) -> Dict[str, Callable]:
    """Rank 0's callbacks on a mesh: each sends its name and inputs to the
    other ranks, then runs."""
    import torch.distributed as dist

    def wrap(name, cb):
        def run(*args):
            dist.broadcast_object_list([(name, args)], src=0)
            return cb(*args)
        return run

    return {name: wrap(name, cb) for name, cb in callbacks.items()}


def follow(callbacks: Dict[str, Callable]) -> int:
    """A rank > 0 on a mesh: run every callback rank 0 sends, with its
    inputs, until rank 0 sends None (``stop_followers``). Returns how many
    ran."""
    import torch.distributed as dist

    ran = 0
    while True:
        msg = [None]
        dist.broadcast_object_list(msg, src=0)
        if msg[0] is None:
            return ran
        name, args = msg[0]
        callbacks[name](*args)
        ran += 1


def stop_followers() -> None:
    """Rank 0: release the followers (the UI has closed)."""
    import torch.distributed as dist

    dist.broadcast_object_list([None], src=0)


def check_gradio():
    """Fail fast (BEFORE the multi-GB pipeline loads) with an actionable
    message when gradio is absent or 4.x+: gr.Image(tool="sketch") would
    otherwise raise an opaque TypeError only after minutes of model load."""
    try:
        import gradio as gr
    except ImportError as e:
        raise RuntimeError(
            "gradio is not installed; the demo callbacks remain usable "
            "programmatically (demo_custom / demo_normal / demo_custom_beta). "
            f"For the UI: pip install gradio=={SUPPORTED_GRADIO}") from e
    major = int(str(getattr(gr, "__version__", "0")).split(".")[0] or 0)
    if major != 3:
        raise RuntimeError(
            f"gradio {gr.__version__} is unsupported: the sketch-mask UI "
            f"uses the 3.x `gr.Image(tool='sketch')` API (removed in "
            f"gradio 4). pip install gradio=={SUPPORTED_GRADIO}")
    return gr


def build_ui(pipe, *, beta: bool = False, callbacks: Optional[Dict[str, Callable]] = None):
    """Construct the gradio Blocks app (requires gradio, see SUPPORTED_GRADIO)
    over `callbacks` (default: ``ui_callbacks(pipe, beta=beta)``)."""
    gr = check_gradio()

    callbacks = callbacks or ui_callbacks(pipe, beta=beta)

    with gr.Blocks(title="textflux") as app:
        gr.Markdown("# TextFlux — scene text synthesis & editing")
        with gr.Tab("Custom Mode"):
            original = gr.Image(type="pil", label="Original", tool="sketch")
            words = gr.Textbox(lines=3, label="Words (one per line)")
            steps = gr.Slider(1, 100, value=30, step=1, label="Steps")
            guidance = gr.Slider(1, 60, value=30, label="Guidance")
            seed = gr.Number(value=42, label="Seed")
            oc = gr.Slider(0, 10, value=2.0, label="Overshoot c (AMO sampler)")
            out = gr.Image(label="Result (cropped)")
            run = gr.Button("Generate")
            run.click(callbacks["custom"], [original, words, steps, guidance, seed, oc], out)
        with gr.Tab("Normal Mode"):
            combined = gr.Image(type="pil", label="Combined image")
            cmask = gr.Image(type="pil", label="Combined mask")
            words2 = gr.Textbox(lines=3, label="Words")
            out2 = gr.Image(label="Result")
            run2 = gr.Button("Generate")
            run2.click(callbacks["normal"], [combined, cmask, words2], out2)
    return app


def main(argv=None):
    import argparse

    from textflux_torch.parallel import partitioning as PT

    p = argparse.ArgumentParser(description="textflux gradio demo (PyTorch)")
    p.add_argument("--model", required=True)
    p.add_argument("--transformer", default=None)
    p.add_argument("--lora", default=None)
    p.add_argument("--beta", action="store_true")
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--quantize", action="store_true",
                   help="quantised DiT + int8 T5 (int8 weight-only by default)")
    p.add_argument("--quantize-mode", choices=["weight_only", "w8a8", "nf4", "mixed"],
                   default=None,
                   help="mixed = 4-bit block interiors + int8 IO boundary. Passing a "
                        "mode implies --quantize")
    p.add_argument("--mesh", default=None,
                   help="dp,fsdp,tp: serve over the ranks torchrun starts, the DiT "
                        f"tensor-parallel over tp; fsdp must be 1 ({PT.ITEM_6B_II}). "
                        "Rank 0 serves the UI")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    # both before the multi-GB pipeline load: the mesh's shape, then gradio
    shape = PT.serving_mesh_shape(args.mesh) if args.mesh else None
    mesh = PT.make_mesh(shape, device=args.device, timeout=DEMO_IDLE) if shape else None
    leader = mesh is None or mesh.rank == 0
    if leader:
        check_gradio()

    from textflux_torch.pipeline.fill import FillPipeline

    pipe = FillPipeline.from_pretrained(
        args.model, transformer_path=args.transformer, lora_path=args.lora,
        quantize=((args.quantize_mode or "weight_only")
                  if (args.quantize or args.quantize_mode) else False),
        mesh=mesh, device=args.device)
    callbacks = ui_callbacks(pipe, beta=args.beta)
    if not leader:
        follow(callbacks)
        return
    if mesh is None:
        build_ui(pipe, callbacks=callbacks).launch(server_port=args.port)
        return
    try:
        build_ui(pipe, callbacks=lead(callbacks)).launch(server_port=args.port)
    finally:
        stop_followers()

if __name__ == "__main__":
    main()
