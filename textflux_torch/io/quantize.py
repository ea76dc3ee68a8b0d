"""Weight quantisation for serving and for frozen QLoRA bases.

The port of ``textflux_tpu/io/quantize.py``. Four modes, chosen per linear:

  * "weight_only": int8 codes with one fp32 scale per output channel
    (w = w_q * scale), dequantised on read into matmuls in the activation
    dtype; halves the DiT's bytes;
  * "w8a8": the same codes, and the activations quantised per token to int8
    as well: the product runs int8 x int8 -> int32 (``torch._int_mm``), then
    is rescaled;
  * "nf4": 4-bit normal-float codes (the bitsandbytes codebook), two per
    byte, with an fp32 absmax per 64 input rows of each output channel
    (optionally double-quantised to uint8 with per-channel fp32 endpoints);
    a quarter of the bf16 bytes. A linear whose input width is not a
    multiple of 128 falls back to weight_only, as in the JAX package;
  * "mixed" (``quantize_tree`` only): weight_only on the input/output
    boundary modules (``MIXED_INT8_NAMES``), nf4 on every block interior.

A quantised linear is a ``QuantLinear``: a module of buffers only (frozen,
never a parameter), put in place of the ``nn.Linear`` it replaces. Its
layout, against the JAX leaf's (which keeps the output axis last):

  ==============  =====================  ============================
  buffer          port                   JAX leaf
  ==============  =====================  ============================
  ``w_q``         int8 (out, in)         ``w_q`` (in, out)
  ``w_q8a8``      int8 (out, in)         ``w_q8a8`` (in, out)
  ``scale``       fp32 (out,)            ``scale`` (out,)
  ``w_nf4``       uint8 (out, in/2)      ``w_nf4`` (in/2, out)
  ``absmax4``     fp32 (out, in/64)      ``absmax4`` (in/64, out)
  ``absmax8``     uint8 (out, in/64)     ``absmax8`` (in/64, out)
  ``amax_lo/hi``  fp32 (out,)            ``amax_lo/hi`` (out,)
  ``bias``        model dtype (out,)     ``b`` (out,)
  ==============  =====================  ============================

so every buffer keeps the output axis FIRST, as ``nn.Linear.weight`` does,
and each port tensor is the transpose of the JAX one. The NF4 packing is a
half split, not an interleave: the low nibble of ``w_nf4[o, r]`` holds input
row r, the high nibble input row r + in/2, and the matmul runs as two
products over the two halves of x. Every mode quantises each output channel
on its own, so a weight can be quantised row block by row block as a
checkpoint streams in (``QuantLinear.load_rows``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

# bitsandbytes NF4 codebook: the 16 quantiles of N(0, 1) scaled to [-1, 1]
NF4_CODEBOOK = (
    -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
    -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
    0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
    0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
    0.7229568362236023, 1.0,
)
NF4_BLOCK = 64
MODES = ("weight_only", "w8a8", "nf4")

# Every tensor of a linear whose FIRST axis is the output axis, in any base
# layout (bf16, int8, w8a8, nf4, double-quantised nf4): the load-time row
# permutations (models.transformer.half_permute_flux_params) gather along it
# and must cover each of them.
OUT_AXIS_KEYS = ("weight", "bias", "w_q", "w_q8a8", "scale", "w_nf4", "absmax4",
                 "absmax8", "amax_lo", "amax_hi")

# Mixed int8/NF4 policy: linears under one of these top-level modules stay
# int8 weight-only (the input embedders and the output head, whose NF4
# error dominates), the rest go NF4.
MIXED_INT8_NAMES = ("img_in", "txt_in", "time_in", "vector_in", "guidance_in",
                    "final_mod", "final_proj")

# quantize_tree leaves linears smaller than this unquantised (read when a
# call passes no min_size). A block's linear counts its size over every
# layer of its stack, as the JAX package's stacked leaves do.
MIN_SIZE = 1 << 16

# int8 x int8 products through torch._int_mm take more than 16 rows on CUDA;
# fewer are padded with zero rows up to this
INT_MM_MIN_ROWS = 17


def _codebook(device) -> torch.Tensor:
    return torch.tensor(NF4_CODEBOOK, dtype=torch.float32, device=device)


def check_mode(mode: str, *, mixed: bool = True) -> str:
    """`mode`, or a ValueError when it names no mode ("mixed" only where a
    policy picks the mode of each linear)."""
    if mode not in MODES + (("mixed",) if mixed else ()):
        raise ValueError(f"unknown quantize mode {mode!r}: expected weight_only | w8a8 | "
                         "nf4 (or 'mixed' via quantize_tree)")
    return mode


def leaf_mode(mode: str, in_features: int) -> str:
    """The mode a linear of `in_features` inputs is stored in: nf4 needs the
    input width to split into two halves of whole 64-row blocks."""
    check_mode(mode, mixed=False)
    if mode == "nf4" and in_features % (2 * NF4_BLOCK) != 0:
        return "weight_only"
    return mode


def quantize_weight(w: torch.Tensor, mode: str, double_quant: bool = False) -> dict:
    """The buffers of a (out, in) weight in `mode` (see the module
    docstring), computed in float32 from `w` as given. `mode` must already
    be the leaf's (``leaf_mode``)."""
    w = w.float()
    if mode in ("weight_only", "w8a8"):
        amax = w.abs().amax(dim=1)
        scale = torch.clamp(amax, min=1e-8) / 127.0
        w_q = torch.clamp(torch.round(w / scale[:, None]), -127, 127).to(torch.int8)
        return {"w_q8a8" if mode == "w8a8" else "w_q": w_q, "scale": scale}
    if mode != "nf4":
        raise ValueError(f"unknown quantize mode {mode!r}")
    out, din = w.shape
    g = din // NF4_BLOCK
    wg = w.reshape(out, g, NF4_BLOCK)
    absmax = torch.clamp(wg.abs().amax(dim=2), min=1e-8)           # (out, g)
    x = wg / absmax[:, :, None]
    code = _codebook(w.device)
    mids = (code[1:] + code[:-1]) / 2.0
    # nearest code: jnp.digitize(x, mids) counts the midpoints <= x
    idx = torch.bucketize(x, mids, right=True).reshape(out, din).to(torch.uint8)
    half = din // 2
    packed = ((idx[:, half:] & 0xF) << 4) | (idx[:, :half] & 0xF)
    if not double_quant:
        return {"w_nf4": packed, "absmax4": absmax}
    lo = absmax.amin(dim=1)
    hi = absmax.amax(dim=1)
    span = torch.clamp(hi - lo, min=1e-12)
    code8 = torch.clamp(torch.round((absmax - lo[:, None]) / span[:, None] * 255.0),
                        0, 255).to(torch.uint8)
    return {"w_nf4": packed, "absmax8": code8, "amax_lo": lo, "amax_hi": hi}


def int_mm(xq: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """int8 (M, K) @ int8 (N, K)^T -> int32 (M, N) through torch._int_mm, the
    counterpart of the JAX package's int8 dot_general. M <= 16 rows are
    padded with zero rows (CUDA's kernel takes more than 16) and sliced
    back: the same products."""
    m = xq.shape[0]
    if m < INT_MM_MIN_ROWS:
        xq = F.pad(xq, (0, 0, 0, INT_MM_MIN_ROWS - m))
    return torch._int_mm(xq, w_q.t())[:m]


class QuantLinear(nn.Module):
    """A frozen linear stored quantised (buffers only; layout in the module
    docstring). ``weight_dtype`` is the dtype a weight is rounded to before
    it is quantised: the model's, as the JAX package quantises the loaded
    (bf16) tree. Built empty (on any device, ``meta`` too) and filled by
    ``load_rows``, or from an ``nn.Linear`` by ``from_linear``."""

    def __init__(self, in_features: int, out_features: int, mode: str, *,
                 bias: bool = True, double_quant: bool = False, device=None,
                 dtype=torch.bfloat16):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.mode = leaf_mode(mode, in_features)
        self.double_quant = double_quant and self.mode == "nf4"
        self.weight_dtype = dtype
        # the layout is quantize_weight's own, traced on the meta device
        layout = quantize_weight(torch.empty(out_features, in_features, device="meta"),
                                 self.mode, self.double_quant)
        for name, t in layout.items():
            self.register_buffer(name, torch.empty(t.shape, dtype=t.dtype, device=device))
        self.register_buffer(
            "bias", torch.empty(out_features, dtype=dtype, device=device) if bias else None)

    @classmethod
    def from_linear(cls, lin: nn.Linear, mode: str, double_quant: bool = False):
        """`lin` quantised (its weight and bias in its own dtype); on the
        ``meta`` device only the empty buffers are made."""
        q = cls(lin.in_features, lin.out_features, mode, bias=lin.bias is not None,
                double_quant=double_quant, device=lin.weight.device, dtype=lin.weight.dtype)
        if lin.weight.device.type != "meta":
            with torch.no_grad():
                q.load_rows(None, lin.weight)
                if lin.bias is not None:
                    q.bias.copy_(lin.bias)
        return q

    def extra_repr(self) -> str:
        return (f"in_features={self.in_features}, out_features={self.out_features}, "
                f"mode={self.mode}, double_quant={self.double_quant}")

    def rows_shape(self, rows: Optional[slice]) -> Tuple[int, int]:
        """The (out, in) shape of the weight rows `rows` (None: all)."""
        return (len(range(self.out_features)[rows or slice(None)]), self.in_features)

    @torch.no_grad()
    def load_rows(self, rows: Optional[slice], w: torch.Tensor) -> None:
        """Quantise `w`, the weight's output rows `rows` (None: all of them),
        into place, on this module's device: rounded to ``weight_dtype``
        first, then quantised in float32."""
        dev = next(iter(self.buffers())).device
        w = w.to(device=dev).to(self.weight_dtype)
        for name, value in quantize_weight(w, self.mode, self.double_quant).items():
            dst = getattr(self, name)
            (dst if rows is None else dst[rows]).copy_(value)

    def nf4_halves(self, dtype) -> Tuple[torch.Tensor, torch.Tensor]:
        """The weight's two input halves ((out, in/2) each) in `dtype`."""
        code = _codebook(self.w_nf4.device)
        if self.double_quant:
            am = self.amax_lo[:, None] + self.absmax8.float() * (
                (self.amax_hi - self.amax_lo)[:, None] / 255.0)
        else:
            am = self.absmax4
        out, half = self.w_nf4.shape
        g2 = half // NF4_BLOCK
        halves = []
        for nib, am_h in ((self.w_nf4 & 0xF, am[:, :g2]), ((self.w_nf4 >> 4) & 0xF, am[:, g2:])):
            vals = code.index_select(0, nib.reshape(-1).int()).reshape(out, g2, NF4_BLOCK)
            vals = vals * am_h[:, :, None]
            halves.append(vals.reshape(out, half).to(dtype))
        return halves[0], halves[1]

    def dequantize(self, dtype=torch.bfloat16) -> torch.Tensor:
        """The (out, in) weight in `dtype` (the JAX ``dequantize_dense``'s
        "w")."""
        if self.mode == "nf4":
            return torch.cat(self.nf4_halves(dtype), dim=1)
        w_q = self.w_q8a8 if self.mode == "w8a8" else self.w_q
        return (w_q.float() * self.scale[:, None]).to(dtype)

    def matmul(self, x: torch.Tensor) -> torch.Tensor:
        """x @ w + b in x's dtype, each mode as the JAX ``layers.dense``
        computes it."""
        if self.mode == "w8a8":
            y = self._w8a8(x)
        elif self.mode == "nf4":
            top, bot = self.nf4_halves(x.dtype)
            half = top.shape[1]
            y = F.linear(x[..., :half], top) + F.linear(x[..., half:], bot)
        else:
            # dequantise in x's dtype: codes cast, times the scale cast
            y = F.linear(x, self.w_q.to(x.dtype) * self.scale.to(x.dtype)[:, None])
        if self.bias is not None:
            y = y + self.bias.to(x.dtype)
        return y

    def _w8a8(self, x: torch.Tensor) -> torch.Tensor:
        """Per-token int8 activations (absmax / 127, floored at 1e-8) times
        the int8 weight, accumulated in int32, rescaled in float32 by the
        token's and the channel's scales, then cast to x's dtype."""
        lead = x.shape[:-1]
        xf = x.reshape(-1, x.shape[-1]).float()
        s = torch.clamp(xf.abs().amax(dim=-1, keepdim=True), min=1e-8) / 127.0
        xq = torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8)
        acc = int_mm(xq, self.w_q8a8)
        y = acc.float() * s * self.scale[None, :]
        return y.reshape(*lead, self.out_features).to(x.dtype)


def _mixed_mode(path: Tuple[str, ...]) -> str:
    return "weight_only" if any(n in path for n in MIXED_INT8_NAMES) else "nf4"


def quantize_tree(model: nn.Module, *, mode: str = "weight_only",
                  min_size: Optional[int] = None, double_quant: bool = False) -> nn.Module:
    """Replace, in place, every ``nn.Linear`` of `model` whose weight holds at
    least `min_size` elements (default ``MIN_SIZE``; a linear inside a
    ``ModuleList`` counts its size times the list's length, as the JAX
    package's stacked leaf does) by a ``QuantLinear`` in `mode`; "mixed"
    picks weight_only or nf4 by module path (``MIXED_INT8_NAMES``). The
    replaced weights are freed as each linear goes. On the ``meta`` device
    this only swaps in the empty quantised modules (what a streaming load
    then fills). Returns `model`."""
    check_mode(mode)
    min_size = MIN_SIZE if min_size is None else min_size

    def rec(module: nn.Module, path: Tuple[str, ...], stack: int) -> None:
        for name, child in list(module.named_children()):
            p = path + (name,)
            if isinstance(child, nn.Linear):
                if child.weight.numel() * stack >= min_size:
                    m = _mixed_mode(p) if mode == "mixed" else mode
                    setattr(module, name, QuantLinear.from_linear(child, m, double_quant))
            else:
                rec(child, p, stack * len(child) if isinstance(child, nn.ModuleList) else stack)

    rec(model, (), 1)
    return model


def quantized_linears(model: nn.Module) -> dict:
    """{module path: its mode} of every QuantLinear in `model`."""
    return {name: m.mode for name, m in model.named_modules() if isinstance(m, QuantLinear)}


def quantized_bytes(module: nn.Module) -> int:
    """Bytes of every parameter and buffer of `module` (what it holds on its
    device: the quantised bytes of a quantised model)."""
    return sum(t.numel() * t.element_size()
               for t in list(module.parameters()) + list(module.buffers()))
