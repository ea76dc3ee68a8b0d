"""LPIPS (AlexNet backbone) as an nn.Module.

The port of ``textflux_tpu/evaluation/lpips.py``, with the architecture of
the `lpips` package the reference uses (eval/eval_fid_lpips.py:115-184): 5
AlexNet conv stages (max pool 3/2 between the first three), the input
scaled by the package's ``(x - shift) / scale``, per-channel unit
normalisation (eps 1e-10), squared feature differences, learned
non-negative 1x1 heads, spatial mean, sum over the stages. Weights load from
a torch ``lpips.LPIPS(net='alex')`` state dict via
``convert_lpips_state_dict`` (no weights ship offline). Images are NHWC in
[-1, 1]; ``lpips_distance`` runs the network in true float32 (TF32 off).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from textflux_torch.device import resolve_device, true_fp32

# AlexNet features: (out_ch, kernel, stride, padding); M = maxpool 3x3 s2
_ALEX = [
    (64, 11, 4, 2), "M",
    (192, 5, 1, 2), "M",
    (384, 3, 1, 1),
    (256, 3, 1, 1),
    (256, 3, 1, 1),
]
_N_STAGES = 5
_STAGE_CHANNELS = (64, 192, 384, 256, 256)

_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


class LPIPS(nn.Module):
    """``convs[i]``: the five AlexNet convs; ``lins[i]``: the 1x1 heads
    (C -> 1, no bias). Random weights from `generator` follow the JAX
    package's init (convs normal * 0.02, heads relu(normal))."""

    def __init__(self, *, device="cuda", dtype=torch.float32, generator=None):
        super().__init__()
        dev = resolve_device(device, allow_meta=True)
        convs, c_in = [], 3
        for spec in _ALEX:
            if spec == "M":
                continue
            out_ch, k, stride, pad = spec
            convs.append(torch.nn.utils.skip_init(nn.Conv2d, c_in, out_ch, k, stride=stride,
                                                  padding=pad, device=dev, dtype=dtype))
            c_in = out_ch
        lins = [torch.nn.utils.skip_init(nn.Conv2d, c, 1, 1, bias=False, device=dev,
                                         dtype=dtype) for c in _STAGE_CHANNELS]
        if dev.type != "meta":
            with torch.no_grad():
                for conv in convs:
                    conv.weight.normal_(generator=generator).mul_(0.02)
                    conv.bias.zero_()
                for lin in lins:
                    lin.weight.normal_(generator=generator).relu_()
        self.convs = nn.ModuleList(convs)
        self.lins = nn.ModuleList(lins)

    def features(self, x: torch.Tensor) -> List[torch.Tensor]:
        """NCHW input -> the 5 post-relu feature maps."""
        feats, i = [], 0
        for spec in _ALEX:
            if spec == "M":
                x = F.max_pool2d(x, 3, 2)
                continue
            x = F.relu(self.convs[i](x))
            feats.append(x)
            i += 1
        return feats

    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Perceptual distance between NHWC images in [-1, 1]. Returns (B,)."""
        shift, scale = (torch.as_tensor(v, device=a.device).view(1, 3, 1, 1)
                        for v in (_SHIFT, _SCALE))
        fa = self.features((a.permute(0, 3, 1, 2) - shift) / scale)
        fb = self.features((b.permute(0, 3, 1, 2) - shift) / scale)
        total = 0.0
        for i in range(_N_STAGES):
            diff = torch.square(_unit_normalize(fa[i]) - _unit_normalize(fb[i]))
            total = total + self.lins[i](diff).mean(dim=(1, 2, 3))
        return total


def _unit_normalize(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    norm = torch.sqrt(torch.sum(torch.square(x), dim=1, keepdim=True))
    return x / (norm + eps)


@torch.inference_mode()
def lpips_distance(model: LPIPS, a, b) -> torch.Tensor:
    """(B,) distances between NHWC images in [-1, 1] (arrays or tensors),
    on the model's device in true float32."""
    dev = model.lins[0].weight.device
    a = torch.as_tensor(np.asarray(a, np.float32), device=dev)
    b = torch.as_tensor(np.asarray(b, np.float32), device=dev)
    with true_fp32():
        return model(a, b)


def convert_lpips_state_dict(sd) -> dict:
    """A torch lpips.LPIPS(net='alex') state dict -> an ``LPIPS`` state dict.

    torch names: net.slice{1..5}.{idx}.weight/bias (features convs) and
    lin{0..4}.model.1.weight or lins.{0..4}.model.1.weight (1x1 heads)."""
    conv_keys = sorted(
        (k for k in sd if k.startswith("net.") and k.endswith(".weight")),
        key=lambda k: (int(k.split(".")[1][5:]), int(k.split(".")[2])))

    def f32(x):
        return torch.from_numpy(np.array(x, np.float32))

    out = {}
    for i, k in enumerate(conv_keys):
        out[f"convs.{i}.weight"] = f32(sd[k])
        out[f"convs.{i}.bias"] = f32(sd[k.replace(".weight", ".bias")])
    for i in range(_N_STAGES):
        key = (f"lin{i}.model.1.weight" if f"lin{i}.model.1.weight" in sd
               else f"lins.{i}.model.1.weight")
        out[f"lins.{i}.weight"] = f32(sd[key])
    return out


def load_lpips(weights_path: str, device="cuda") -> LPIPS:
    """An ``LPIPS`` from a locally provided lpips.LPIPS(net='alex') state
    dict file, on `device`."""
    sd = torch.load(weights_path, map_location="cpu")
    model = LPIPS(device="meta")
    model.load_state_dict(convert_lpips_state_dict(
        {k: v.numpy() for k, v in sd.items()}), assign=True)
    return model.to(resolve_device(device)).eval()


# lpips.LPIPS(net='alex') names the AlexNet convs by their index in
# torchvision's alexnet.features, split into five slices at the taps
_LPIPS_CONV_KEYS = ("net.slice1.0", "net.slice2.3", "net.slice3.6", "net.slice4.8",
                    "net.slice5.10")


def random_lpips_state_dict(generator: torch.Generator) -> dict:
    """An lpips.LPIPS(net='alex')-named state dict of random float32 values
    on the CPU (He-scaled convs, non-negative heads) for smoke runs and
    tests: no weights ship with the repository."""
    sd, c_in, i = {}, 3, 0
    for spec in _ALEX:
        if spec == "M":
            continue
        out_ch, k, _, _ = spec
        key = _LPIPS_CONV_KEYS[i]
        sd[f"{key}.weight"] = (torch.randn(out_ch, c_in, k, k, generator=generator)
                               * (2.0 / (c_in * k * k)) ** 0.5)
        sd[f"{key}.bias"] = 0.01 * torch.randn(out_ch, generator=generator)
        c_in, i = out_ch, i + 1
    for i, c in enumerate(_STAGE_CHANNELS):
        sd[f"lin{i}.model.1.weight"] = torch.rand(1, c, 1, 1, generator=generator) / c
    return sd
