"""The safetensors file format, read and written with PyTorch alone.

A file is an 8-byte little-endian header length N, N bytes of JSON, then the
tensor bytes. The header maps each name to ``{"dtype", "shape",
"data_offsets": [begin, end]}`` (offsets from the end of the header) and may
hold string ``__metadata__``. Tensors are little-endian and C-contiguous.

``SafetensorsFile`` maps a file with ``mmap`` and builds each tensor with
``torch.frombuffer`` straight from the mapping (private, copy-on-write
pages, so the tensors are writable and nothing is read before it is used).
bf16 goes through torch, never numpy. ``save_file`` writes the header
first, padded with spaces to a multiple of 8, then each tensor in turn,
copied to the host one at a time from whatever device it is on.
"""

from __future__ import annotations

import json
import math
import mmap
import os
import struct
from typing import Dict, Mapping, Optional, Tuple

import torch

DTYPES = {
    "BOOL": torch.bool,
    "U8": torch.uint8,
    "I8": torch.int8,
    "I16": torch.int16,
    "I32": torch.int32,
    "I64": torch.int64,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "F32": torch.float32,
    "F64": torch.float64,
}
for _name, _attr in (("U16", "uint16"), ("U32", "uint32"), ("U64", "uint64"),
                     ("F8_E4M3", "float8_e4m3fn"), ("F8_E5M2", "float8_e5m2")):
    if hasattr(torch, _attr):
        DTYPES[_name] = getattr(torch, _attr)
NAMES = {v: k for k, v in DTYPES.items()}

MAX_HEADER = 100_000_000   # the format's own limit


def read_header(path: str) -> Tuple[dict, int]:
    """(header dict, byte offset of the data) of one file."""
    with open(path, "rb") as f:
        raw = f.read(8)
        if len(raw) != 8:
            raise ValueError(f"{path}: not a safetensors file (shorter than 8 bytes)")
        (n,) = struct.unpack("<Q", raw)
        if n > MAX_HEADER:
            raise ValueError(f"{path}: header of {n} bytes exceeds {MAX_HEADER}")
        header = json.loads(f.read(n))
    return header, 8 + n


class SafetensorsFile:
    """One mapped safetensors file: ``keys()``, ``get_tensor(name)``,
    ``metadata()``. Tensors returned stay valid after ``close()``: each
    holds the mapping alive."""

    def __init__(self, path: str):
        self.path = path
        header, self._start = read_header(path)
        self._meta = header.pop("__metadata__", None)
        self._entries = header
        size = os.path.getsize(path)
        data_len = size - self._start
        for name, e in header.items():
            if e["dtype"] not in DTYPES:
                raise ValueError(f"{path}: {name} has dtype {e['dtype']}, not one of "
                                 f"{sorted(DTYPES)}")
            begin, end = e["data_offsets"]
            want = math.prod(e["shape"]) * _itemsize(DTYPES[e["dtype"]])
            if end - begin != want or not 0 <= begin <= end <= data_len:
                raise ValueError(f"{path}: {name} has offsets {e['data_offsets']} for "
                                 f"{want} bytes in a {data_len}-byte data section")
        self._mm = None
        if size > self._start:
            with open(path, "rb") as f:
                self._mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)

    def keys(self):
        # in file order, so a reader walks the mapping front to back
        return sorted(self._entries, key=lambda k: self._entries[k]["data_offsets"][0])

    def metadata(self) -> Optional[Dict[str, str]]:
        return self._meta

    def get_tensor(self, name: str) -> torch.Tensor:
        e = self._entries[name]
        dtype, shape = DTYPES[e["dtype"]], tuple(e["shape"])
        begin, end = e["data_offsets"]
        if end == begin:
            return torch.empty(shape, dtype=dtype)
        flat = torch.frombuffer(self._mm, dtype=torch.uint8, count=end - begin,
                                offset=self._start + begin)
        if dtype == torch.bool:
            return flat.view(torch.bool).reshape(shape)
        if (self._start + begin) % _itemsize(dtype):
            flat = flat.clone()   # a view of another dtype needs its alignment
        return flat.view(dtype).reshape(shape)

    def close(self) -> None:
        self._mm = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def save_file(tensors: Mapping[str, torch.Tensor], path: str,
              metadata: Optional[Mapping[str, str]] = None, *,
              dtype: Optional[torch.dtype] = None) -> int:
    """Write `tensors` to `path`; returns the bytes written. The tensors
    may be views on any device (non-contiguous too): each is made
    contiguous and copied to the host on its own, as it is written, so no
    second copy of the whole dict is ever held. With `dtype`, tensors of
    one dimension or more are cast to it on the way. Larger items come
    first, as the safetensors package orders them, so every tensor starts
    at a multiple of its item size."""
    def out_dtype(t):
        return dtype if dtype is not None and t.dim() >= 1 else t.dtype

    order = sorted(tensors, key=lambda k: (-_itemsize(out_dtype(tensors[k])), k))
    header: Dict[str, object] = {}
    if metadata:
        if not all(isinstance(k, str) and isinstance(v, str) for k, v in metadata.items()):
            raise TypeError("safetensors metadata must map str to str")
        header["__metadata__"] = dict(metadata)
    offset = 0
    for k in order:
        t, dt = tensors[k], out_dtype(tensors[k])
        if dt not in NAMES:
            raise TypeError(f"{k}: dtype {dt} has no safetensors name")
        n = t.numel() * _itemsize(dt)
        header[k] = {"dtype": NAMES[dt], "shape": list(t.shape),
                     "data_offsets": [offset, offset + n]}
        offset += n
    raw = json.dumps(header, separators=(",", ":")).encode("utf-8")
    raw += b" " * (-len(raw) % 8)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for k in order:
            t = tensors[k].detach()
            if t.numel() == 0:
                continue
            host = t.to(device="cpu", dtype=out_dtype(t)).contiguous().reshape(-1)
            f.write(memoryview(host.view(torch.uint8).numpy()))
    return 8 + len(raw) + offset
