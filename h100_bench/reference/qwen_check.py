"""The comparison that decides a Qwen-Image edit cell's ``correct``.

For each sampled request the reference works out again, from the request's
files and the seed, what the program derived: the canvas and its mask
(``canvas.conditioning``), the prompt and the negative prompt " " inside
the chat template as byte ids, their embeddings, the Wan VAE's normalised
posterior mean of the canvas, the initial latents (the same
``torch.Generator`` draw, seeded with the request's noise seed) and the
sigma schedule. It then judges what the program produced:

* ``text_rel``: the positive and the negative embedding, each at its own
  length (the program pads them for its graphs; the padding is not
  judged), relative L2 gap, the worse of the two;
* ``latent_rel``: the canvas's normalised, packed latents z0;
* ``mask_max_abs``: the packed latent mask (exact);
* ``noise_max_abs``: the initial latents against the same draw in bf16
  (exact);
* ``stage_rel``: the DiT judged part by part at the first of two steps
  drawn from the seed, for the prompt and for the negative: the embedders,
  the head and, in blocks drawn from the seed, each block's modulation
  vectors, attention branch, MLP input and MLPs, each run by the reference
  on the program's own input to it (the program's latents, its text
  embedding widened to float32, its streams), relative L2 gap, the worst
  part (``qwen_image.stage_gaps``);
* ``glue_ulp``: in those blocks, each stream after the block against the
  float32 sum of the program's own input, gated attention and gated MLP,
  in bf16 last places of the largest of the three sums on the way (the
  residual additions alone: four roundings, two of them of terms up to
  twice the stream's size, read at most about 3);
* ``rerun_max_abs``: the velocities those parts come from (the program's
  forward run again after the window, eagerly, on the arguments the window
  gave it) against the window's own, exact: what is judged is the window's
  arithmetic;
* ``guidance_ulp``: the guided velocity at both steps against the float32
  true CFG of the program's own two velocities, in bf16 last places (the
  combination alone: rounding to nearest reads at most 0.5);
* ``update_ulp``: the latents after the first of those steps against the
  float32 Euler step of the program's guided velocity over the reference's
  sigmas, blended with the program's z0, mask and initial draw, in units of
  the state's last place in bf16;
* ``blend_ulp``: over every step of every request of the window, the
  unmasked tokens of the state after the step against z0 noised to the
  next sigma with the initial draw, in bf16 last places (the driver reads
  it as the window runs);
* ``decode_mean_abs``: the program's image against the reference's decode
  of the program's final latents, mean absolute difference in grey levels.

Each number is the worst over the sampled requests. Beside them the
program's side reports what two planted faults would read on its own
values (``no_rescale.guidance_ulp``: the guidance without its norm
rescale; ``skipped_blend.blend_ulp``: the first judged step's update left
unblended), for the limits' upper readings. The control replaces
the program by the reference computed at a lower precision and is judged
by the same numbers (its guidance, update, blend, residual sums and rerun
are exact by construction: a step left unchanged, planted in the
reference's place, reads beside them).
"""

from __future__ import annotations

import gc

import numpy as np
import torch

from h100_bench.reference import canvas, models as M
from h100_bench.reference import qwen_image as Q, qwen_text as QT, vae_wan as W
from h100_bench.reference.serve_check import _rel, bf16_ulps

NEGATIVE_PROMPT = " "


def _free():
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def latent_mask(mask, f: int, z: int):
    """(B, H, W) pixel mask -> packed (B, T, 4 z): each latent pixel takes
    the mask's top-left pixel of its f x f block (nearest interpolation),
    repeated over the z channels."""
    return M.pack_latents(mask[:, ::f, ::f, None].expand(-1, -1, -1, z))


@torch.inference_mode()
def reference_outputs(cfg: dict, seed: int, recs: list, device, rounding: dict) -> list:
    """Per record: what the reference (or, with a control's `rounding`, the
    control) computes in the program's place, at the program's own
    latents where a step is judged alone."""
    out = [dict() for _ in recs]
    dev = torch.device(device)
    prompts = [canvas.prompts(r["words"])[1] for r in recs]
    embeds = QT.encode(cfg["qwen_text"], seed, prompts + [NEGATIVE_PROMPT], dev,
                       rounding.get("qwen_text", "fp32"))
    for o, e in zip(out, embeds):
        o["txt_pos"], o["txt_neg"] = e, embeds[-1]
    _free()
    vcfg = cfg["wan_vae"]
    vae = W.build(vcfg, seed, dev, rounding.get("wan_vae", "fp32"))
    f = 2 ** (len(vcfg["dim_mult"]) - 1)
    for r, o in zip(recs, out):
        img, mask, (h, w) = canvas.conditioning(r["scene"], r["mask_file"], r["words"])
        img, mask = torch.as_tensor(img, device=dev), torch.as_tensor(mask, device=dev)
        o["z0"] = M.pack_latents(W.encode(vae, img))
        o["mask"] = latent_mask(mask, f, vcfg["z_dim"])
        grid = (h // f // 2, w // f // 2)
        gen = torch.Generator(device=dev).manual_seed(r["noise_seed"])
        o["lat0"] = torch.randn((1, grid[0] * grid[1], 4 * vcfg["z_dim"]), generator=gen,
                                device=dev, dtype=torch.float32)
        o["grid"] = grid
        o["sigmas"] = Q.schedule(r["steps"], grid[0] * grid[1])
        if "final" in r:
            o["image"] = canvas.to_uint8(W.decode(vae, M.unpack_latents(
                r["final"].float(), 2 * grid[0], 2 * grid[1])).cpu().numpy())[0]
    del vae
    _free()
    jobs, where = [], []
    for i, (r, o) in enumerate(zip(recs, out)):
        k = min(r["x"])
        for kind in ("pos", "neg"):
            jobs.append(dict(r["stages"][kind], x=r["x"][k], txt=r["txt_" + kind],
                             sigma=float(o["sigmas"][k]), grid=o["grid"], v=r["v_" + kind][k]))
            where.append((i, kind))
    gaps = Q.stage_gaps(cfg["qwen_dit"], seed, jobs, dev, rounding.get("qwen_dit", "fp32"))
    for (i, kind), g in zip(where, gaps):
        out[i].setdefault("stages", {})[kind] = g
    _free()
    return out


def glue_ulps(blocks: dict) -> float:
    """The worst residual sum of the judged blocks (``glue_ulp``): each
    stream's output against in + gate1 attn + gate2 mlp in float32, over
    bf16's last place at the largest of |in|, |in + gate1 attn| and the
    exact output."""
    worst = 0.0
    for got in blocks.values():
        for s, mod in enumerate(got["mods"][::-1]):      # (img, txt) -> txt first
            chunks = mod.float().chunk(6, -1)
            x = got["in"][s].float()
            mid = x + chunks[2][:, None] * got["attn"][s].float()
            exact = mid + chunks[5][:, None] * got["mlp"][s].float()
            top = torch.maximum(torch.maximum(x.abs(), mid.abs()), exact.abs())
            _, e = torch.frexp(top)
            ulp = torch.ldexp(torch.ones_like(top), e - 8)
            worst = max(worst, float(((got["out"][s].float() - exact).abs() / ulp).max()))
    return worst


NUMBERS = ("text_rel", "latent_rel", "mask_max_abs", "noise_max_abs", "stage_rel",
           "glue_ulp", "rerun_max_abs", "guidance_ulp", "update_ulp", "blend_ulp",
           "decode_mean_abs")
MADE = {"txt_pos", "txt_neg", "z0", "mask", "lat0", "final", "blend_ulp", "stages",
        "rerun_max_abs"}


def judge(recs: list, ref: list, prog: list = None) -> dict:
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
        put("latent_rel", _rel(p["z0"], o["z0"]))
        put("mask_max_abs", (p["mask"].float() - o["mask"].float()).abs().max())
        lat0 = r["lat0"].to(torch.bfloat16).float()
        put("noise_max_abs", (lat0 - o["lat0"].to(torch.bfloat16).float()).abs().max())
        # the reference's gaps hold the program's, a control's its own
        for stage, gap_prog, gap_ctl in (g for kind in ("pos", "neg")
                                         for g in (o if prog is None else p)["stages"][kind]):
            gap = gap_prog if prog is None else gap_ctl
            put("stage_rel", gap)
            put("stage_rel." + stage.split(".")[0], gap)
        # the control's residual sums and rerun are exact by construction
        put("glue_ulp", 0.0 if prog is not None else max(
            glue_ulps(r["stages"][kind]["blocks"]) for kind in ("pos", "neg")))
        put("rerun_max_abs", 0.0 if prog is not None else r["rerun_max_abs"])
        for k in sorted(r["x"]):
            put("guidance_ulp", 0.0 if prog is not None else bf16_ulps(
                r["v"][k], Q.guide(r["v_pos"][k], r["v_neg"][k], r["cfg_scale"])))
        k = min(r["x"])
        sig = o["sigmas"]

        def stepped(x, v):
            return Q.euler_blend(x, v, sig[k], sig[k + 1], r["mask"], r["z0"], r["lat0"])

        if prog is None:
            put("update_ulp", bf16_ulps(r["x"][k + 1], stepped(r["x"][k], r["v"][k])))
            put("blend_ulp", r["blend_ulp"])
            img = r["image"].astype(np.float32)
            # what two planted faults would read here: the guidance without
            # its norm rescale, and step k's Euler update left unblended
            # (its unmasked tokens against z0 noised to the next sigma)
            c, u = r["v_pos"][k].float(), r["v_neg"][k].float()
            put("no_rescale.guidance_ulp", bf16_ulps(r["v"][k], u + r["cfg_scale"] * (c - u)))
            unblended = (r["x"][k].float() + (float(sig[k + 1]) - float(sig[k]))
                         * r["v"][k].float()).to(torch.bfloat16)
            kept = stepped(r["x"][k], r["v"][k])
            dev = (unblended.float() - kept).abs() / torch.ldexp(
                torch.ones_like(kept), torch.frexp(unblended.float())[1] - 8)
            put("skipped_blend.blend_ulp", (dev * (1.0 - r["mask"].float())).max())
        else:
            put("update_ulp", 0.0)   # the control's update is exact by construction
            put("blend_ulp", 0.0)
            # the fault "a step returns its state unchanged", planted in the
            # reference's place: x_{k+1} = x_k
            put("unchanged_step.update_ulp", bf16_ulps(r["x"][k], stepped(r["x"][k], r["v"][k])))
            img = p["image"].astype(np.float32)
        put("decode_mean_abs", np.abs(img - o["image"].astype(np.float32)).mean())
    return worst
