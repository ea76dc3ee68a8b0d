"""PP-OCRv3-style CTC recognizer as an nn.Module (inference).

The port of ``textflux_tpu/evaluation/ppocr.py``, with the architecture of
the reference's self-contained recognizer (eval/ocr_recog/):
MobileNetV1Enhance backbone (scale 0.5, last_conv_stride (1,2), avg pool),
SVTR sequence neck (C/8 -> 120-dim 2-block global-attention encoder with
swish MLPs), Im2Seq reshape, CTC head. Config as created by
eval/recognizer.py:91-98; char dict semantics ('sos' + chars + ' ', blank
index 0) per eval/recognizer.py:222-231.

The module's parameter names are the reference RecModel's
(``backbone.block_list.3._depthwise_conv._conv.weight``, ...), so a
RecModel state dict loads through ``convert_ppocr_state_dict`` key for key.
Inputs are NHWC (the JAX package's layout); inside, the convolutions run in
NCHW. Every conv pads k//2 on each side, as torch does (XLA's "SAME" padded
a stride-2 conv asymmetrically). The SVTR attention is einsum - softmax -
einsum, as the JAX package writes it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from textflux_torch.device import resolve_device, true_fp32


@dataclasses.dataclass(frozen=True)
class PPOCRConfig:
    n_class: int = 6625          # zh; en = 97
    scale: float = 0.5
    svtr_dims: int = 64
    svtr_depth: int = 2
    svtr_hidden: int = 120
    svtr_heads: int = 8
    svtr_mlp_ratio: float = 2.0
    image_shape: Tuple[int, int, int] = (3, 48, 320)   # C, H, W


# ---------------------------------------------------------------------------
# Primitives
# ---------------------------------------------------------------------------

def _hard_swish(x):
    return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def _hard_sigmoid(x):
    return torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def _swish(x):
    return x * torch.sigmoid(x)


_ACTS = {"hard_swish": _hard_swish, "swish": _swish, None: lambda x: x}


class BatchNorm(nn.Module):
    """Inference BatchNorm (eps 1e-5) with the reference's parameter names."""

    def __init__(self, c: int, *, device=None, dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(c, device=device, dtype=dtype))
        self.register_buffer("running_mean", torch.zeros(c, device=device, dtype=dtype))
        self.register_buffer("running_var", torch.ones(c, device=device, dtype=dtype))

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            False, 0.0, 1e-5)


def _conv(c_in, c_out, k, *, stride=(1, 1), groups=1, bias=False, dev=None, dtype=None,
          generator=None, std=0.05):
    """nn.Conv2d padded k//2 on every side; weights normal * `std` (the JAX
    package's init), zero bias."""
    conv = torch.nn.utils.skip_init(nn.Conv2d, c_in, c_out, k, stride=stride,
                                    padding=(k // 2, k // 2), groups=groups, bias=bias,
                                    device=dev, dtype=dtype)
    if dev is None or torch.device(dev).type != "meta":
        with torch.no_grad():
            conv.weight.normal_(generator=generator).mul_(std)
            if bias:
                conv.bias.zero_()
    return conv


class ConvBN(nn.Module):
    """conv (no bias) + BatchNorm + activation; the reference names the two
    ``_conv`` / ``_batch_norm`` in the backbone and ``conv`` / ``norm`` in
    the neck (`names`)."""

    def __init__(self, c_in, c_out, k, *, stride=(1, 1), groups=1, act="hard_swish",
                 names=("_conv", "_batch_norm"), dev=None, dtype=None, generator=None):
        super().__init__()
        self.names, self.act = names, act
        self.add_module(names[0], _conv(c_in, c_out, k, stride=stride,
                                        groups=groups, dev=dev, dtype=dtype,
                                        generator=generator))
        self.add_module(names[1], BatchNorm(c_out, device=dev, dtype=dtype))

    def forward(self, x):
        conv, bn = (getattr(self, n) for n in self.names)
        return _ACTS[self.act](bn(conv(x)))


class SEModule(nn.Module):
    def __init__(self, c, *, dev=None, dtype=None, generator=None):
        super().__init__()
        self.conv1 = _conv(c, c // 4, 1, bias=True, dev=dev, dtype=dtype, generator=generator)
        self.conv2 = _conv(c // 4, c, 1, bias=True, dev=dev, dtype=dtype, generator=generator)

    def forward(self, x):
        s = x.mean(dim=(2, 3), keepdim=True)
        s = F.relu(self.conv1(s))
        return x * _hard_sigmoid(self.conv2(s))


# ---------------------------------------------------------------------------
# Backbone: MobileNetV1Enhance
# ---------------------------------------------------------------------------

# (filters1, filters2, groups, stride, dw_size, use_se) per block
_BLOCK_SPECS = (
    (32, 64, 32, (1, 1), 3, False),
    (64, 128, 64, (1, 1), 3, False),
    (128, 128, 128, (1, 1), 3, False),
    (128, 256, 128, (2, 1), 3, False),
    (256, 256, 256, (1, 1), 3, False),
    (256, 512, 256, (2, 1), 3, False),
    (512, 512, 512, (1, 1), 5, False),
    (512, 512, 512, (1, 1), 5, False),
    (512, 512, 512, (1, 1), 5, False),
    (512, 512, 512, (1, 1), 5, False),
    (512, 512, 512, (1, 1), 5, False),
    (512, 1024, 512, (2, 1), 5, True),
    (1024, 1024, 1024, (1, 2), 5, True),   # last_conv_stride = (1, 2)
)


class DepthwiseSeparable(nn.Module):
    def __init__(self, f1, f2, g, stride, dw, use_se, s, **kw):
        super().__init__()
        c = int(f1 * s)
        # depthwise groups int(g * s): with g == f1, one group per channel
        self._depthwise_conv = ConvBN(c, c, dw, stride=stride, groups=int(g * s), **kw)
        self._se = SEModule(c, **kw) if use_se else None
        self._pointwise_conv = ConvBN(c, int(f2 * s), 1, **kw)

    def forward(self, x):
        x = self._depthwise_conv(x)
        if self._se is not None:
            x = self._se(x)
        return self._pointwise_conv(x)


class MobileNetV1Enhance(nn.Module):
    def __init__(self, s, **kw):
        super().__init__()
        self.conv1 = ConvBN(3, int(32 * s), 3, stride=(2, 2), **kw)
        self.block_list = nn.ModuleList(DepthwiseSeparable(*spec, s, **kw)
                                        for spec in _BLOCK_SPECS)

    def forward(self, x):
        """(B, 3, H, W) -> (B, 512*scale, H', W')."""
        x = self.conv1(x)
        for blk in self.block_list:
            x = blk(x)
        return F.avg_pool2d(x, 2, 2)


# ---------------------------------------------------------------------------
# Neck: SVTR sequence encoder
# ---------------------------------------------------------------------------

def _linear(i, o, *, dev=None, dtype=None, generator=None):
    lin = torch.nn.utils.skip_init(nn.Linear, i, o, device=dev, dtype=dtype)
    if dev is None or torch.device(dev).type != "meta":
        with torch.no_grad():
            lin.weight.normal_(generator=generator).mul_(0.02)
            lin.bias.zero_()
    return lin


class _Mixer(nn.Module):
    def __init__(self, hd, **kw):
        super().__init__()
        self.qkv = _linear(hd, 3 * hd, **kw)
        self.proj = _linear(hd, hd, **kw)


class _MLP(nn.Module):
    def __init__(self, hd, hidden, **kw):
        super().__init__()
        self.fc1 = _linear(hd, hidden, **kw)
        self.fc2 = _linear(hidden, hd, **kw)


def _layer_norm(dim, dev, dtype):
    return nn.LayerNorm(dim, device=dev, dtype=dtype)


class SVTRBlock(nn.Module):
    """Transformer block with swish MLP (RecSVTR.Block), as the JAX package
    computes it: x + attn(LN1(x)), then + mlp(LN2(x)), LN eps 1e-5."""

    def __init__(self, hd, heads, mlp_ratio, *, dev=None, dtype=None, generator=None):
        super().__init__()
        kw = dict(dev=dev, dtype=dtype, generator=generator)
        self.heads = heads
        self.norm1 = _layer_norm(hd, dev, dtype)
        self.mixer = _Mixer(hd, **kw)
        self.norm2 = _layer_norm(hd, dev, dtype)
        self.mlp = _MLP(hd, int(hd * mlp_ratio), **kw)

    def forward(self, x):
        b, n, c = x.shape
        y = F.layer_norm(x, (c,), self.norm1.weight, self.norm1.bias, 1e-5)
        qkv = self.mixer.qkv(y).reshape(b, n, 3, self.heads, c // self.heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        logits = torch.einsum("bhqd,bhkd->bhqk", q, k) * (c // self.heads) ** -0.5
        attn = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhqk,bhkd->bhqd", attn, v).transpose(1, 2).reshape(b, n, c)
        x = x + self.mixer.proj(out)
        y = F.layer_norm(x, (c,), self.norm2.weight, self.norm2.bias, 1e-5)
        return x + self.mlp.fc2(_swish(self.mlp.fc1(y)))


class EncoderWithSVTR(nn.Module):
    def __init__(self, cfg: PPOCRConfig, c, **kw):
        super().__init__()
        hd, cbn = cfg.svtr_hidden, dict(kw, act="swish", names=("conv", "norm"))
        self.conv1 = ConvBN(c, c // 8, 3, **cbn)
        self.conv2 = ConvBN(c // 8, hd, 1, **cbn)
        self.svtr_block = nn.ModuleList(
            SVTRBlock(hd, cfg.svtr_heads, cfg.svtr_mlp_ratio, **kw)
            for _ in range(cfg.svtr_depth))
        self.norm = _layer_norm(hd, kw.get("dev"), kw.get("dtype"))
        self.conv3 = ConvBN(hd, c, 1, **cbn)
        self.conv4 = ConvBN(2 * c, c // 8, 3, **cbn)
        self.conv1x1 = ConvBN(c // 8, cfg.svtr_dims, 1, **cbn)

    def forward(self, x):
        """(B, C, H, W) -> (B, H*W, svtr_dims) sequence."""
        skip = x
        z = self.conv2(self.conv1(x))
        b, c, h, w = z.shape
        z = z.flatten(2).transpose(1, 2)
        for blk in self.svtr_block:
            z = blk(z)
        z = F.layer_norm(z, (c,), self.norm.weight, self.norm.bias, 1e-6)
        z = z.transpose(1, 2).reshape(b, c, h, w)
        z = self.conv3(z)
        z = self.conv1x1(self.conv4(torch.cat([skip, z], dim=1)))
        return z.flatten(2).transpose(1, 2)


class _Neck(nn.Module):
    def __init__(self, cfg, c, **kw):
        super().__init__()
        self.encoder = EncoderWithSVTR(cfg, c, **kw)


class _Head(nn.Module):
    def __init__(self, cfg, **kw):
        super().__init__()
        self.fc = _linear(cfg.svtr_dims, cfg.n_class, **kw)


class RecModel(nn.Module):
    """The recognizer: (B, H, W, 3) normalised images -> (B, T, n_class) CTC
    logits. Random weights from `generator` follow the JAX package's init
    (convs normal * 0.05, linears normal * 0.02, BatchNorm identity)."""

    def __init__(self, cfg: PPOCRConfig = PPOCRConfig(), *, device="cuda",
                 dtype=torch.float32, generator=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(dev=resolve_device(device, allow_meta=True), dtype=dtype,
                  generator=generator)
        self.backbone = MobileNetV1Enhance(cfg.scale, **kw)
        self.neck = _Neck(cfg, int(1024 * cfg.scale), **kw)
        self.head = _Head(cfg, **kw)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        seq = self.neck.encoder(self.backbone(images.permute(0, 3, 1, 2)))
        return self.head.fc(seq)


# ---------------------------------------------------------------------------
# Decoding + preprocessing
# ---------------------------------------------------------------------------

def ctc_greedy_decode(logits: np.ndarray, charset: Sequence[str]) -> List[str]:
    """Greedy CTC: argmax, collapse repeats, drop blank (index 0)."""
    ids = np.asarray(logits).argmax(axis=-1)
    texts = []
    for row in ids:
        chars, prev = [], -1
        for t in row:
            if t != prev and t != 0 and t < len(charset):
                chars.append(charset[t])
            prev = t
        texts.append("".join(chars))
    return texts


def load_charset(path: str) -> List[str]:
    """Char dict: index 0 = blank ('sos'), then file lines, then space."""
    with open(path, "rb") as f:
        chars = [line.decode("utf-8").strip("\n").strip("\r\n") for line in f]
    return ["sos"] + chars + [" "]


def _resize_bilinear_align_corners(img: np.ndarray, out_h: int,
                                   out_w: int) -> np.ndarray:
    """torch F.interpolate(mode='bilinear', align_corners=True) semantics:
    corner-aligned sampling grid, NO antialias filter (PIL's BILINEAR
    antialiases and uses half-pixel centres). Host numpy, as the JAX
    package computes it."""
    h, w = img.shape[:2]
    ys = np.linspace(0.0, h - 1.0, out_h) if out_h > 1 else np.zeros(1)
    xs = np.linspace(0.0, w - 1.0, out_w) if out_w > 1 else np.zeros(1)
    y0 = np.floor(ys).astype(np.int64)
    x0 = np.floor(xs).astype(np.int64)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = (ys - y0)[:, None, None]
    wx = (xs - x0)[None, :, None]
    im = img.astype(np.float32)
    top = im[y0][:, x0] * (1.0 - wx) + im[y0][:, x1] * wx
    bot = im[y1][:, x0] * (1.0 - wx) + im[y1][:, x1] * wx
    return top * (1.0 - wy) + bot * wy


def preprocess_crop(crop: np.ndarray, image_shape=(3, 48, 320)) -> np.ndarray:
    """uint8 (H, W, 3) crop -> normalized, ratio-preserving, right-padded
    (1, 48, 320, 3) float32 (eval_dgocr.py pre_process semantics, NHWC:
    align_corners bilinear resize, zero right-padding)."""
    _, img_h, img_w = image_shape
    h, w = crop.shape[:2]
    resized_w = min(int(math.ceil(img_h * w / h)), img_w)
    resized = _resize_bilinear_align_corners(crop, img_h, max(resized_w, 1))
    resized = (resized / 255.0 - 0.5) / 0.5
    out = np.zeros((img_h, img_w, 3), np.float32)
    out[:, :resized.shape[1]] = resized
    return out[None]


# ---------------------------------------------------------------------------
# torch checkpoint conversion
# ---------------------------------------------------------------------------

def convert_ppocr_state_dict(sd, cfg: PPOCRConfig) -> dict:
    """A reference RecModel torch state dict -> a ``RecModel(cfg)`` state
    dict in float32: the same names (BatchNorm's num_batches_tracked and any
    key the module does not have are dropped); raises on a missing key."""
    want = RecModel(cfg, device="meta").state_dict()
    missing = [k for k in want if k not in sd]
    if missing:
        raise KeyError(f"RecModel state dict lacks {len(missing)} keys, e.g. {missing[:3]}")
    out = {}
    for k, ref in want.items():
        v = torch.from_numpy(np.array(sd[k], np.float32))
        if tuple(v.shape) != tuple(ref.shape):
            raise ValueError(f"{k}: shape {tuple(v.shape)} != {tuple(ref.shape)}")
        out[k] = v
    return out


class PPOCRRecognizer:
    """crop -> text callable (the eval_ocr CLI recognizer protocol), on the
    model's device in true float32."""

    def __init__(self, model: RecModel, charset: Sequence[str]):
        self.model = model.eval()
        self.cfg = model.cfg
        self.charset = list(charset)

    @classmethod
    def from_torch_checkpoint(cls, ckpt_path: str, char_dict_path: str,
                              lang: str = "ch", device="cuda") -> "PPOCRRecognizer":
        cfg = PPOCRConfig(n_class=6625 if lang == "ch" else 97)
        sd = torch.load(ckpt_path, map_location="cpu")
        model = RecModel(cfg, device="meta")
        model.load_state_dict(convert_ppocr_state_dict(
            {k: v.numpy() for k, v in sd.items()}, cfg), assign=True)
        return cls(model.to(resolve_device(device)), load_charset(char_dict_path))

    @torch.inference_mode()
    def logits(self, crop: np.ndarray) -> np.ndarray:
        dev = self.model.head.fc.weight.device
        x = torch.as_tensor(preprocess_crop(crop, self.cfg.image_shape), device=dev)
        with true_fp32():
            return self.model(x).cpu().numpy()

    def __call__(self, crop: np.ndarray) -> str:
        return ctc_greedy_decode(self.logits(crop), self.charset)[0]


# ---------------------------------------------------------------------------
# Module-level entry point for `eval_ocr --recognizer ...ppocr:recognize`
# ---------------------------------------------------------------------------

_DEFAULT_RECOGNIZER: Optional[PPOCRRecognizer] = None


def recognize(crop: np.ndarray) -> str:
    """crop -> text, lazily building a PPOCRRecognizer on first call (on
    CUDA, or on the CPU when ``PPOCR_DEVICE=cpu``).

    This is the entry point the eval_ocr CLI is pointed at
    (``--recognizer textflux_torch.evaluation.ppocr:recognize``). The torch
    checkpoint + char dict are located via environment variables, because the
    reference repo ships the PP-OCRv3 weights as missing blobs and they must
    be provisioned locally:

      PPOCR_CKPT  path to the torch .pth state dict (RecModel layout,
                  eval/ocr_recog/RecModel.py)  [default: ./eval/ocr_weights/ppv3_rec.pth]
      PPOCR_DICT  char-dict txt                 [default: ./eval/ocr_weights/ppocr_keys_v1.txt]
      PPOCR_LANG  'ch' or 'en'                  [default: ch]
    """
    global _DEFAULT_RECOGNIZER
    if _DEFAULT_RECOGNIZER is None:
        import os

        ckpt = os.environ.get("PPOCR_CKPT", "./eval/ocr_weights/ppv3_rec.pth")
        cdict = os.environ.get("PPOCR_DICT", "./eval/ocr_weights/ppocr_keys_v1.txt")
        lang = os.environ.get("PPOCR_LANG", "ch")
        missing = [p for p in (ckpt, cdict) if not os.path.exists(p)]
        if missing:
            raise FileNotFoundError(
                "PP-OCRv3 recognizer weights not found: "
                + ", ".join(missing)
                + ". Set PPOCR_CKPT / PPOCR_DICT (the reference distributes "
                "these separately; see .MISSING_LARGE_BLOBS), or pass a "
                "different --recognizer entry point to eval_ocr."
            )
        _DEFAULT_RECOGNIZER = PPOCRRecognizer.from_torch_checkpoint(
            ckpt, cdict, lang=lang, device=os.environ.get("PPOCR_DEVICE", "cuda"))
    return _DEFAULT_RECOGNIZER(crop)


def random_recmodel_state_dict(cfg: PPOCRConfig, generator: torch.Generator) -> dict:
    """A RecModel-named state dict of random float32 values on the CPU
    (He-scaled convs, 1/sqrt(fan_in) linears, BatchNorm statistics and
    LayerNorm affines near the identity, BatchNorm's num_batches_tracked as
    the reference saves it) for smoke runs and tests: no weights ship with
    the repository."""
    sd = {}
    for name, ref in RecModel(cfg, device="meta").state_dict().items():
        shape, leaf = tuple(ref.shape), name.rsplit(".", 1)[-1]
        if leaf == "weight" and len(shape) == 4:
            fan_in = shape[1] * shape[2] * shape[3]
            v = torch.randn(*shape, generator=generator) * (2.0 / fan_in) ** 0.5
        elif leaf == "weight" and len(shape) == 2:
            v = torch.randn(*shape, generator=generator) / shape[1] ** 0.5
        elif leaf in ("weight", "running_var"):
            v = 0.5 + torch.rand(*shape, generator=generator)
        else:   # biases, running means
            v = 0.1 * torch.randn(*shape, generator=generator)
        sd[name] = v
        if leaf == "running_var":
            sd[name.rsplit(".", 1)[0] + ".num_batches_tracked"] = torch.tensor(0)
    return sd
