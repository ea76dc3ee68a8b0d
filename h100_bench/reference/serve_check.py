"""The comparison that decides an edit cell's ``correct``.

For each sampled request the reference works out again, from the request's
files and the seed, everything the program derived: the canvas, the token
ids, the CLIP and T5 embeddings, the VAE posterior (with the same standard
normal draws, taken from a ``torch.Generator`` seeded with the request's
noise seed in the pipeline's order: the posterior's, then the initial
latents'), the packed conditioning and the sigma schedule. It then judges
what the program produced:

* ``clip_rel`` / ``t5_rel``: the pooled and sequence embeddings the DiT
  got, relative L2 gap to the reference's;
* ``cond_rel``: the packed conditioning tokens (VAE encode + mask);
* ``noise_max_abs``: the initial latents against the same draw in bf16
  (exact);
* ``velocity_rel``: the DiT's velocity at two recorded steps, with the
  program's own latents at that step as the input (the reference's
  embeddings and conditioning beside them), relative L2 gap;
* ``update_ulp``: the latents after the first of those steps against the
  Euler update of the program's velocity over the reference's sigmas, in
  float32, in units of the state's last place in bf16 (the configuration's
  latents are bf16: rounding to nearest reads at most 0.5; a state left
  unchanged reads the update's size, tens of units);
* ``decode_mean_abs``: the program's image against the reference's decode
  of the program's final latents, mean absolute difference in grey levels.

Each number is the worst over the sampled requests. The control replaces
the program by the reference computed at a lower precision; it is judged
by the same numbers.
"""

from __future__ import annotations

import gc

import numpy as np
import torch

from h100_bench import weights
from h100_bench.reference import canvas, models as M


def build(kind: str, cfg: dict, seed: int, device, rounding: str = "fp32"):
    """The reference's `kind` model with the seed's weights in float32,
    its linears rounded for `rounding`."""
    model = M.MODELS[kind](cfg)
    model.load_state_dict(weights.state_dict(seed, kind, weights.groups(model), device,
                                             torch.float32), assign=True, strict=True)
    model.requires_grad_(False)
    M.round_weights(model, rounding)
    return model


def _free():
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def bf16_ulps(x, exact) -> float:
    """max |x - exact| in units of bf16's last place at x."""
    _, e = torch.frexp(x.float())
    return float(((x.float() - exact).abs() / torch.ldexp(torch.ones_like(exact), e - 8)).max())


def _rel(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


@torch.inference_mode()
def reference_outputs(cfg: dict, seed: int, recs: list, device, rounding: dict) -> list:
    """Per record: what the reference (or, with a control's `rounding`, the
    control) computes in the program's place, at the program's own inputs
    where the step is judged alone."""
    out = [dict() for _ in recs]
    dev = torch.device(device)
    t5 = build("t5", cfg["t5"], seed, dev, rounding.get("t5", "fp32"))
    for r, o in zip(recs, out):
        ids = torch.as_tensor(canvas.t5_ids(canvas.prompts(r["words"])[1],
                                            cfg["max_sequence_length"]), device=dev)
        o["txt"] = M.t5_encode(t5, ids)
    del t5
    _free()
    clip = build("clip", cfg["clip"], seed, dev, rounding.get("clip", "fp32"))
    for r, o in zip(recs, out):
        ids = torch.as_tensor(canvas.clip_ids(canvas.prompts(r["words"])[0]), device=dev)
        o["pooled"] = M.clip_pooled(clip, ids)
    del clip
    _free()
    vae = build("vae", cfg["vae"], seed, dev, rounding.get("vae", "fp32"))
    vcfg = vae.cfg
    f = 2 ** (len(vcfg["block_out_channels"]) - 1)
    for r, o in zip(recs, out):
        img, mask, (h, w) = canvas.conditioning(r["scene"], r["mask"], r["words"])
        img, mask = torch.as_tensor(img, device=dev), torch.as_tensor(mask, device=dev)
        mean, logvar = M.vae_moments(vae, img * (1.0 - mask[..., None]))
        gen = torch.Generator(device=dev).manual_seed(r["noise_seed"])
        eps = torch.randn(mean.shape, generator=gen, device=dev, dtype=torch.float32)
        z = (mean + torch.exp(0.5 * logvar) * eps - vcfg["shift_factor"]) * vcfg["scaling_factor"]
        o["cond"] = torch.cat([M.pack_latents(z), M.pack_mask(mask, f)], dim=-1)
        t_img = (h // f // 2) * (w // f // 2)
        o["lat0"] = torch.randn((1, t_img, 4 * vcfg["latent_channels"]), generator=gen,
                                device=dev, dtype=torch.float32)
        o["lat_hw"] = (h // f, w // f)
        o["sigmas"] = M.make_schedule(r["steps"], t_img)
        if "final" in r:
            o["image"] = canvas.to_uint8(M.vae_decode(vae, M.unpack_latents(
                r["final"].float(), *o["lat_hw"])).cpu().numpy())[0]
    del vae
    _free()
    flux = build("flux", cfg["flux"], seed, dev, rounding.get("flux", "fp32"))
    for r, o in zip(recs, out):
        o["v"] = {}
        for k, x in r["x"].items():
            tokens = torch.cat([x.float(), o["cond"]], dim=-1)
            o["v"][k] = M.flux_velocity(flux, tokens, o["txt"], o["pooled"], o["sigmas"][k],
                                        r["guidance"], *o["lat_hw"])
    del flux
    _free()
    return out


# what a request has to have produced to be judged; a record without it
# reads infinite on every number
NUMBERS = ("clip_rel", "t5_rel", "cond_rel", "noise_max_abs", "velocity_rel", "update_ulp",
           "decode_mean_abs")
MADE = {"pooled", "txt", "cond", "lat0", "final"}


def judge(recs: list, ref: list, prog: list = None) -> dict:
    """The numbers, worst over the records: the program's (`recs`) or, when
    `prog` is given, a control's outputs, against the reference's `ref`."""
    worst = {}

    def put(name, value):
        worst[name] = max(worst.get(name, 0.0), float(value))

    for i, (r, o) in enumerate(zip(recs, ref)):
        p = prog[i] if prog is not None else None
        if p is None and not (MADE <= set(r) and len(r["x"]) == 2):
            for name in NUMBERS:     # the program never produced what is judged
                put(name, float("inf"))
            continue
        put("clip_rel", _rel(p["pooled"] if p else r["pooled"], o["pooled"]))
        put("t5_rel", _rel(p["txt"] if p else r["txt"], o["txt"]))
        put("cond_rel", _rel(p["cond"] if p else r["cond"], o["cond"]))
        lat0 = (p["lat0"] if p else r["lat0"]).to(torch.bfloat16).float()
        put("noise_max_abs", (lat0 - o["lat0"].to(torch.bfloat16).float()).abs().max())
        for k in sorted(r["x"]):
            put("velocity_rel", _rel(p["v"][k] if p else r["v"][k], o["v"][k]))
        k = min(r["x"])
        if p is None:
            put("update_ulp", bf16_ulps(r["x"][k + 1], r["x"][k].float() + (
                float(o["sigmas"][k + 1]) - float(o["sigmas"][k])) * r["v"][k].float()))
            img = r["image"].astype(np.float32)
        else:
            put("update_ulp", 0.0)   # the control's update is exact by construction
            # the fault "a step returns its state unchanged", planted in the
            # reference's place: x_{k+1} = x_k
            put("unchanged_step.update_ulp", bf16_ulps(r["x"][k], r["x"][k].float() + (
                float(o["sigmas"][k + 1]) - float(o["sigmas"][k])) * o["v"][k]))
            img = p["image"].astype(np.float32)
        put("decode_mean_abs", np.abs(img - o["image"].astype(np.float32)).mean())
    return worst
