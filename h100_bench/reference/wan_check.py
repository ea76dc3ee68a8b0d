"""The comparison that decides a Wan2.1-VACE clip cell's ``correct``.

For each sampled request the reference works out again, from the request's
files and the seed, what the program derived: every frame's canvas and mask
(``canvas.conditioning`` frame by frame), the prompt and the negative
prompt as byte ids, their UMT5 embeddings over the padded 512, the Wan
VAE's normalised posterior means of the clip outside the mask (inactive)
and inside it (reactive), the mask's 64 channels, the initial latents (the
same ``torch.Generator`` draw, seeded with the request's noise seed) and
the sigma schedule. It then judges what the program produced:

* ``text_rel``: the positive and the negative embedding over all 512 rows
  (the rows past each prompt are zero on both sides), relative L2 gap,
  the worse of the two;
* ``latent_rel``: the inactive and reactive latents of the clip, relative
  L2 gap over both;
* ``mask_max_abs``: the control's 64 mask channels (exact);
* ``noise_max_abs``: the initial latents against the same draw in bf16
  (exact);
* ``stage_rel``: the DiT judged part by part at the first of two steps
  drawn from the seed, for the prompt and for the negative: the
  embedders, the head and, in main and branch blocks drawn from the seed,
  each block's modulation vectors, self-attention branch, cross-attention
  branch and FFN, the branch's ``proj_in`` and each judged branch block's
  hint, each run by the reference on the program's own input to it (the
  program's latents, control and text widened to float32, its streams),
  relative L2 gap, the worst part (``wan_vace.stage_gaps``);
* ``glue_ulp``: in those blocks, each residual sum on the way (after the
  gated self-attention, after the cross-attention, after the gated FFN,
  and after a main block's hint) against the float32 sum of the program's
  own terms, in bf16 last places of the largest term (a few roundings of
  terms up to the stream's size: at most about 2);
* ``rerun_max_abs``: the velocities those parts come from (the program's
  forward run again after the window, eagerly, on the arguments the
  window gave it) against the window's own, exact;
* ``guidance_ulp``: the guided velocity at both steps against the float32
  CFG of the program's own two velocities, in bf16 last places (one
  rounding: at most 0.5);
* ``update_ulp``: the latents after the first of those steps against the
  float32 Euler step of the program's guided velocity over the reference's
  sigmas, in bf16 last places (one rounding);
* ``decode_mean_abs``: every frame of the program's clip against the
  reference's decode of the program's final latents, mean absolute
  difference in grey levels.

Each number is the worst over the sampled requests. Beside them the
program's side reports what two planted faults would read on its own
values (``no_cfg.guidance_ulp``: the prompt's velocity taken as the guided
one; ``dropped_hint.glue_ulp``: a main block's hint left out), for the
limits' upper readings. The control replaces the program by the reference
computed at a lower precision and is judged by the same numbers (its
guidance, update, residual sums and rerun are exact by construction: a
step left unchanged, planted in the reference's place, reads beside them).
"""

from __future__ import annotations

import gc

import numpy as np
import torch

from h100_bench.clips import frame_files
from h100_bench.reference import canvas, umt5 as U, vae_wan as W, vae_wan_video as WV
from h100_bench.reference import wan_vace as R
from h100_bench.reference.serve_check import _rel, bf16_ulps

# the negative prompt the cell's program is built with: a fixed stand-in
# for Wan's default, which the repository does not hold
NEGATIVE_PROMPT = ("bright colors, overexposed, static, blurred details, subtitles, "
                   "worst quality, low quality, ugly, deformed, still picture")
Z = 16


def _free():
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def clip_conditioning(clip_dir: str, mask_file: str, words):
    """The clip's canvases and masks as the model takes them: ((1, T, H, W,
    3) in [-1, 1], (T, H, W) in {0, 1}) float32 tensors, and (H, W)."""
    imgs, masks = [], []
    for f in frame_files(clip_dir):
        img, mask, hw = canvas.conditioning(f, mask_file, words)
        imgs.append(img[0])
        masks.append(mask[0])
    return torch.as_tensor(np.stack(imgs))[None], torch.as_tensor(np.stack(masks)), hw


@torch.inference_mode()
def reference_outputs(cfg: dict, seed: int, recs: list, device, rounding: dict) -> list:
    """Per record: what the reference (or, with a control's `rounding`, the
    control) computes in the program's place, at the program's own
    latents where a step is judged alone."""
    out = [dict() for _ in recs]
    dev = torch.device(device)
    prompts = [canvas.prompts(r["words"])[1] for r in recs]
    embeds = U.encode(cfg["umt5"], seed, prompts + [NEGATIVE_PROMPT], dev,
                      rounding.get("umt5", "fp32"))
    for o, e in zip(out, embeds):
        o["txt_pos"], o["txt_neg"] = e, embeds[-1]
    del embeds
    _free()
    vae = W.build(cfg["wan_vae"], seed, dev, rounding.get("wan_vae", "fp32"))
    f = 2 ** (len(cfg["wan_vae"]["dim_mult"]) - 1)
    for r, o in zip(recs, out):
        video, mask, (h, w) = clip_conditioning(r["scene"], r["mask_file"], r["words"])
        video, mask = video.to(dev), mask.to(dev)
        m = mask[None, ..., None]
        o["z"] = torch.cat([WV.encode(vae, video * (1.0 - m)), WV.encode(vae, video * m)], -1)
        t_lat = o["z"].shape[1]
        o["mask"] = R.mask_control(mask, t_lat, f)
        gen = torch.Generator(device=dev).manual_seed(r["noise_seed"])
        o["lat0"] = torch.randn((1, Z, t_lat, h // f, w // f), generator=gen, device=dev,
                                dtype=torch.float32).permute(0, 2, 3, 4, 1)
        o["sigmas"] = R.schedule(r["steps"], cfg["scheduler"]["flow_shift"])
        if "final" in r:
            frames = WV.decode(vae, r["final"].to(dev).float())
            o["image"] = canvas.to_uint8(frames.cpu().numpy())[0]
        del video, mask, m
        _free()
    del vae
    _free()
    jobs, where = [], []
    for i, (r, o) in enumerate(zip(recs, out)):
        k = min(r["x"])
        for kind in ("pos", "neg"):
            jobs.append(dict(r["stages"][kind], sigma=float(o["sigmas"][k]),
                             v=r["v_" + kind][k]))
            where.append((i, kind))
    gaps = R.stage_gaps(cfg["wan_dit"], seed, jobs, dev, rounding.get("wan_dit", "fp32"))
    for (i, kind), g in zip(where, gaps):
        out[i].setdefault("stages", {})[kind] = g
    _free()
    return out


NUMBERS = ("text_rel", "latent_rel", "mask_max_abs", "noise_max_abs", "stage_rel",
           "glue_ulp", "rerun_max_abs", "guidance_ulp", "update_ulp", "decode_mean_abs")
MADE = {"txt_pos", "txt_neg", "control", "lat0", "final", "stages", "rerun_max_abs"}


def _dropped_hint(job: dict, vace_layers) -> float:
    """What ``glue_ulp`` would read had a judged main block's hint been
    left out: its stream before the hint against the stream with it."""
    worst = 0.0
    for i, got in job["blocks"].items():
        if "hinted" in got:
            hint = job["vace"][list(vace_layers).index(i)]["hint"].float()
            worst = max(worst, bf16_ulps(got["out"], got["out"].float() + hint))
    return worst


def judge(recs: list, ref: list, prog: list = None, vace_layers=()) -> dict:
    """The numbers, worst over the records: the program's (`recs`) or, when
    `prog` is given, a control's outputs, against the reference's `ref`."""
    worst = {}

    def put(name, value):
        worst[name] = max(worst.get(name, 0.0), float(value))

    for i, (r, o) in enumerate(zip(recs, ref)):
        p = prog[i] if prog is not None else r
        if prog is None and not (MADE <= set(r) and len(r["x"]) == 2 and len(r["stages"]) == 2
                                 and all(len(r[n]) == 2 for n in ("v_pos", "v_neg", "v"))):
            for name in NUMBERS:     # the program never produced what is judged
                put(name, float("inf"))
            continue
        put("text_rel", max(_rel(p["txt_pos"], o["txt_pos"]), _rel(p["txt_neg"], o["txt_neg"])))
        z = p["z"] if prog is not None else p["control"][..., :2 * Z]
        put("latent_rel", _rel(z, o["z"]))
        if prog is None:
            put("mask_max_abs", (r["control"][..., 2 * Z:].float().cpu()
                                 - o["mask"].float().cpu()).abs().max())
            lat0 = r["lat0"].to(torch.bfloat16).float().cpu()
            put("noise_max_abs", (lat0 - o["lat0"].to(torch.bfloat16).float().cpu()).abs().max())
        else:
            put("mask_max_abs", 0.0)     # the control builds them as the reference does
            put("noise_max_abs", 0.0)
        for stage, gap_prog, gap_ctl in (g for kind in ("pos", "neg")
                                         for g in (o if prog is None else p)["stages"][kind]):
            gap = gap_prog if prog is None else gap_ctl
            put("stage_rel", gap)
            put("stage_rel." + stage.split(".")[0], gap)
        k = min(r["x"])
        sig = o["sigmas"]
        if prog is None:
            put("glue_ulp", max(R.glue_ulps(r["stages"][kind], vace_layers)
                                for kind in ("pos", "neg")))
            put("dropped_hint.glue_ulp", max(_dropped_hint(r["stages"][kind], vace_layers)
                                             for kind in ("pos", "neg")))
            put("rerun_max_abs", r["rerun_max_abs"])
            for step in sorted(r["x"]):
                put("guidance_ulp", bf16_ulps(r["v"][step], R.guide(
                    r["v_pos"][step], r["v_neg"][step], r["cfg_scale"])))
                put("no_cfg.guidance_ulp", bf16_ulps(r["v_pos"][step], R.guide(
                    r["v_pos"][step], r["v_neg"][step], r["cfg_scale"])))
            put("update_ulp", bf16_ulps(r["x"][k + 1], R.euler(r["x"][k], r["v"][k], sig[k],
                                                              sig[k + 1])))
            img = r["image"].astype(np.float32)
        else:
            # the control's residual sums, rerun, guidance and update are
            # exact by construction; the fault "a step returns its state
            # unchanged", planted in the reference's place: x_{k+1} = x_k
            for name in ("glue_ulp", "rerun_max_abs", "guidance_ulp", "update_ulp"):
                put(name, 0.0)
            put("unchanged_step.update_ulp", bf16_ulps(r["x"][k], R.euler(
                r["x"][k], r["v"][k], sig[k], sig[k + 1])))
            img = p["image"].astype(np.float32)
        put("decode_mean_abs", np.abs(img - o["image"].astype(np.float32)).mean())
    return worst
