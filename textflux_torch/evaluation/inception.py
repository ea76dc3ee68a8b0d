"""InceptionV3 pool3 feature extractor for FID, as an nn.Module.

The port of ``textflux_tpu/evaluation/inception.py``: the same graph,
`pytorch_fid`'s FIDInceptionV3 (the torchvision inception_v3 graph with the
FID modifications; the reference shells out to ``python -m pytorch_fid``,
eval/eval_fid_lpips.py:75-102):

  - Mixed_5b/5c/5d (InceptionA), Mixed_6b..6e (InceptionC) and Mixed_7b
    (InceptionE_1) use avg-pooling that EXCLUDES padding from the divisor
    (``count_include_pad=False``);
  - Mixed_7c (InceptionE_2) uses a 3x3/1 MAX pool in its pool branch.

Weights load from a torch state dict (torchvision inception_v3 or
pytorch_fid's FIDInceptionV3: identical key names) via
``convert_inception_state_dict``; each conv's BatchNorm (eps=1e-3) is folded
into the conv weight/bias at conversion, which is exact in inference mode.

Input protocol: NHWC float in [-1, 1] (the harness's loading convention),
any spatial size, resized to 299x299 with ``F.interpolate(bilinear,
align_corners=False, antialias=False)``: half-pixel centres, no antialias,
as pytorch_fid resizes. Output: (N, 2048) pool3 features. The convolutions
run in NCHW; ``make_fid_extractor`` runs them in true float32 (TF32 off).
"""

from __future__ import annotations

import math
import pickle

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from textflux_torch.device import resolve_device, true_fp32

# (name, kh, kw, c_in, c_out, stride[, "valid"]) per conv module, torchvision
# names. Stride-2 and "valid" convs are unpadded; the others pad k//2 per axis.
_STEM = [
    ("Conv2d_1a_3x3", 3, 3, 3, 32, 2),
    ("Conv2d_2a_3x3", 3, 3, 32, 32, 1, "valid"),
    ("Conv2d_2b_3x3", 3, 3, 32, 64, 1),
    # maxpool1 3x3/2
    ("Conv2d_3b_1x1", 1, 1, 64, 80, 1),
    ("Conv2d_4a_3x3", 3, 3, 80, 192, 1, "valid"),
    # maxpool2 3x3/2
]


def _a_spec(c_in, pool_features):
    return [
        ("branch1x1", 1, 1, c_in, 64, 1),
        ("branch5x5_1", 1, 1, c_in, 48, 1),
        ("branch5x5_2", 5, 5, 48, 64, 1),
        ("branch3x3dbl_1", 1, 1, c_in, 64, 1),
        ("branch3x3dbl_2", 3, 3, 64, 96, 1),
        ("branch3x3dbl_3", 3, 3, 96, 96, 1),
        ("branch_pool", 1, 1, c_in, pool_features, 1),
    ]


def _b_spec(c_in):
    return [
        ("branch3x3", 3, 3, c_in, 384, 2),
        ("branch3x3dbl_1", 1, 1, c_in, 64, 1),
        ("branch3x3dbl_2", 3, 3, 64, 96, 1),
        ("branch3x3dbl_3", 3, 3, 96, 96, 2),
    ]


def _c_spec(c_in, c7):
    return [
        ("branch1x1", 1, 1, c_in, 192, 1),
        ("branch7x7_1", 1, 1, c_in, c7, 1),
        ("branch7x7_2", 1, 7, c7, c7, 1),
        ("branch7x7_3", 7, 1, c7, 192, 1),
        ("branch7x7dbl_1", 1, 1, c_in, c7, 1),
        ("branch7x7dbl_2", 7, 1, c7, c7, 1),
        ("branch7x7dbl_3", 1, 7, c7, c7, 1),
        ("branch7x7dbl_4", 7, 1, c7, c7, 1),
        ("branch7x7dbl_5", 1, 7, c7, 192, 1),
        ("branch_pool", 1, 1, c_in, 192, 1),
    ]


def _d_spec(c_in):
    return [
        ("branch3x3_1", 1, 1, c_in, 192, 1),
        ("branch3x3_2", 3, 3, 192, 320, 2),
        ("branch7x7x3_1", 1, 1, c_in, 192, 1),
        ("branch7x7x3_2", 1, 7, 192, 192, 1),
        ("branch7x7x3_3", 7, 1, 192, 192, 1),
        ("branch7x7x3_4", 3, 3, 192, 192, 2),
    ]


def _e_spec(c_in):
    return [
        ("branch1x1", 1, 1, c_in, 320, 1),
        ("branch3x3_1", 1, 1, c_in, 384, 1),
        ("branch3x3_2a", 1, 3, 384, 384, 1),
        ("branch3x3_2b", 3, 1, 384, 384, 1),
        ("branch3x3dbl_1", 1, 1, c_in, 448, 1),
        ("branch3x3dbl_2", 3, 3, 448, 384, 1),
        ("branch3x3dbl_3a", 1, 3, 384, 384, 1),
        ("branch3x3dbl_3b", 3, 1, 384, 384, 1),
        ("branch_pool", 1, 1, c_in, 192, 1),
    ]


_BLOCKS = [
    ("Mixed_5b", "A", _a_spec(192, 32)),
    ("Mixed_5c", "A", _a_spec(256, 64)),
    ("Mixed_5d", "A", _a_spec(288, 64)),
    ("Mixed_6a", "B", _b_spec(288)),
    ("Mixed_6b", "C", _c_spec(768, 128)),
    ("Mixed_6c", "C", _c_spec(768, 160)),
    ("Mixed_6d", "C", _c_spec(768, 160)),
    ("Mixed_6e", "C", _c_spec(768, 192)),
    ("Mixed_7a", "D", _d_spec(768)),
    ("Mixed_7b", "E1", _e_spec(1280)),
    ("Mixed_7c", "E2", _e_spec(2048)),
]


def all_conv_specs():
    """(torchvision module path, spec) of every conv, in graph order."""
    for spec in _STEM:
        yield spec[0], spec
    for name, _, specs in _BLOCKS:
        for spec in specs:
            yield f"{name}.{spec[0]}", spec


def _padding(spec):
    _, kh, kw, _, _, stride = spec[:6]
    if stride == 2 or (len(spec) > 6 and spec[6] == "valid"):
        return (0, 0)
    return (kh // 2, kw // 2)


class InceptionV3(nn.Module):
    """FID InceptionV3 up to pool3. One ``nn.Conv2d`` (BatchNorm folded in)
    per torchvision conv module: ``stem[<name>]`` and
    ``blocks[<Mixed_x>][<branch>]``. Random weights from `generator` follow
    the JAX package's init (normal / sqrt(fan_in), zero bias)."""

    def __init__(self, *, device="cuda", dtype=torch.float32, generator=None):
        super().__init__()
        dev = resolve_device(device, allow_meta=True)

        def make(spec):
            _, kh, kw, cin, cout, stride = spec[:6]
            conv = torch.nn.utils.skip_init(nn.Conv2d, cin, cout, (kh, kw), stride=stride,
                                            padding=_padding(spec), device=dev, dtype=dtype)
            if dev.type != "meta":
                with torch.no_grad():
                    conv.weight.normal_(generator=generator).mul_(1.0 / math.sqrt(kh * kw * cin))
                    conv.bias.zero_()
            return conv

        self.stem = nn.ModuleDict({s[0]: make(s) for s in _STEM})
        self.blocks = nn.ModuleDict({name: nn.ModuleDict({s[0]: make(s) for s in specs})
                                     for name, _, specs in _BLOCKS})

    def conv(self, path: str) -> nn.Conv2d:
        parts = path.split(".")
        return self.stem[parts[0]] if len(parts) == 1 else self.blocks[parts[0]][parts[1]]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC images in [-1, 1] -> (N, 2048) pool3 features."""
        x = x.permute(0, 3, 1, 2)
        if x.shape[2:] != (299, 299):
            x = F.interpolate(x, size=(299, 299), mode="bilinear", align_corners=False,
                              antialias=False)
        for spec in _STEM:
            x = F.relu(self.stem[spec[0]](x))
            if spec[0] in ("Conv2d_2b_3x3", "Conv2d_4a_3x3"):
                x = F.max_pool2d(x, 3, 2)
        for name, kind, _ in _BLOCKS:
            x = _apply_block(self.blocks[name], x, kind)
        return x.mean(dim=(2, 3))


def _avg_pool_3x3(x):
    """3x3/1 average pool, padding excluded from the divisor (the FID
    modification)."""
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


def _apply_block(p: nn.ModuleDict, x: torch.Tensor, kind: str) -> torch.Tensor:
    def c(name, y):
        return F.relu(p[name](y))

    def chain(y, *names):
        for name in names:
            y = c(name, y)
        return y

    if kind == "A":
        return torch.cat([
            c("branch1x1", x),
            chain(x, "branch5x5_1", "branch5x5_2"),
            chain(x, "branch3x3dbl_1", "branch3x3dbl_2", "branch3x3dbl_3"),
            c("branch_pool", _avg_pool_3x3(x)),
        ], dim=1)
    if kind == "B":
        return torch.cat([
            c("branch3x3", x),
            chain(x, "branch3x3dbl_1", "branch3x3dbl_2", "branch3x3dbl_3"),
            F.max_pool2d(x, 3, 2),
        ], dim=1)
    if kind == "C":
        return torch.cat([
            c("branch1x1", x),
            chain(x, "branch7x7_1", "branch7x7_2", "branch7x7_3"),
            chain(x, "branch7x7dbl_1", "branch7x7dbl_2", "branch7x7dbl_3",
                  "branch7x7dbl_4", "branch7x7dbl_5"),
            c("branch_pool", _avg_pool_3x3(x)),
        ], dim=1)
    if kind == "D":
        return torch.cat([
            chain(x, "branch3x3_1", "branch3x3_2"),
            chain(x, "branch7x7x3_1", "branch7x7x3_2", "branch7x7x3_3", "branch7x7x3_4"),
            F.max_pool2d(x, 3, 2),
        ], dim=1)
    # E1 / E2: split branches; E2 swaps the avg pool for a 3x3/1 max pool
    b3 = c("branch3x3_1", x)
    b3 = torch.cat([c("branch3x3_2a", b3), c("branch3x3_2b", b3)], dim=1)
    dbl = chain(x, "branch3x3dbl_1", "branch3x3dbl_2")
    dbl = torch.cat([c("branch3x3dbl_3a", dbl), c("branch3x3dbl_3b", dbl)], dim=1)
    pool = F.max_pool2d(x, 3, 1, 1) if kind == "E2" else _avg_pool_3x3(x)
    return torch.cat([c("branch1x1", x), b3, dbl, c("branch_pool", pool)], dim=1)


def inception_pool3_features(model: InceptionV3, x: torch.Tensor) -> torch.Tensor:
    """NHWC images in [-1, 1] -> (N, 2048) pool3 features."""
    return model(x)


def make_fid_extractor(model: InceptionV3):
    """images (N,H,W,3) in [-1,1] -> (N,2048) np features (fid.py protocol),
    on the model's device in true float32."""
    dev = next(model.parameters()).device

    @torch.inference_mode()
    def extract(images: np.ndarray) -> np.ndarray:
        x = torch.as_tensor(np.asarray(images, np.float32), device=dev)
        with true_fp32():
            return model(x).cpu().numpy()

    return extract


def convert_inception_state_dict(sd) -> dict:
    """torchvision inception_v3 / pytorch_fid FIDInceptionV3 state dict ->
    an ``InceptionV3`` state dict, folding each BatchNorm (eps=1e-3) into its
    conv, in float32 as the JAX package folds:
        w' = w * gamma / sqrt(var + eps);  b' = beta - mean * gamma / sqrt(...)
    """
    eps = 1e-3
    out = {}
    for path, _ in all_conv_specs():
        def get(key):
            return np.asarray(sd[f"{path}.{key}"], np.float32)

        k = get("bn.weight") / np.sqrt(get("bn.running_var") + eps)
        w = get("conv.weight") * k[:, None, None, None]
        b = get("bn.bias") - get("bn.running_mean") * k
        prefix = ("blocks." if "." in path else "stem.") + path
        out[f"{prefix}.weight"] = torch.from_numpy(w)
        out[f"{prefix}.bias"] = torch.from_numpy(b)
    return out


def load_torch_file(path: str):
    """torch.load on the CPU. A state dict loads under torch's default
    ``weights_only=True``; a pickled module object (which that refuses) is
    loaded again with ``weights_only=False``, as the JAX package loads
    every file: only load files you trust."""
    try:
        return torch.load(path, map_location="cpu")
    except pickle.UnpicklingError:
        return torch.load(path, map_location="cpu", weights_only=False)


def load_inception_extractor(weights_path: str, device="cuda"):
    """Build the FID extractor from a locally provided torch weights file (a
    state dict, or a pickled module with ``state_dict()``)."""
    obj = load_torch_file(weights_path)
    sd = obj.state_dict() if hasattr(obj, "state_dict") else obj
    model = InceptionV3(device="meta")
    model.load_state_dict(convert_inception_state_dict(
        {k: v.numpy() if hasattr(v, "numpy") else v for k, v in sd.items()}), assign=True)
    return make_fid_extractor(model.to(resolve_device(device)).eval())


def random_torchvision_state_dict(generator: torch.Generator) -> dict:
    """A torchvision-named InceptionV3 state dict of random float32 values
    on the CPU (``<conv>.conv.weight`` with He scaling and ``<conv>.bn.*``
    statistics near the identity) for smoke runs and tests: no weights
    ship with the repository."""
    def rand(*shape):
        return torch.rand(*shape, generator=generator)

    sd = {}
    for path, (_, kh, kw, cin, cout, *_rest) in all_conv_specs():
        sd[f"{path}.conv.weight"] = (torch.randn(cout, cin, kh, kw, generator=generator)
                                     * math.sqrt(2.0 / (cin * kh * kw)))
        sd[f"{path}.bn.weight"] = 0.5 + rand(cout)
        sd[f"{path}.bn.bias"] = 0.1 * torch.randn(cout, generator=generator)
        sd[f"{path}.bn.running_mean"] = 0.1 * torch.randn(cout, generator=generator)
        sd[f"{path}.bn.running_var"] = 0.5 + rand(cout)
        sd[f"{path}.bn.num_batches_tracked"] = torch.tensor(0)
    return sd
