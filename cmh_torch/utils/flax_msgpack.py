"""Read (and, for tests and ``chip_smoke.py``, write) flax's msgpack files
without flax or the ``msgpack`` package.

cmh_tpu's ``save_model`` writes ``model-N.msgpack`` with
``flax.serialization.to_bytes({"params": …, "model_state": …})``: a
msgpack map of maps whose leaves are arrays in flax's ext types

- 1: an ndarray, itself a msgpack array ``[shape, dtype name, C-order
  bytes]``;
- 2: a complex number, a msgpack array ``[real, imag]``;
- 3: a numpy scalar, encoded as ext 1 of shape ``()``;

and whose arrays above ``MAX_CHUNK_SIZE`` bytes are split into
``{"__msgpack_chunked_array__": True, "shape": {"0": …}, "chunks": {"0":
…}}`` (flax's ``_chunk``). ``load`` and ``loads`` decode the whole format
that flax emits (nil, bool, every int width, float32/64, str, bin, array,
map, ext) into dicts, lists and numpy arrays, rebuilding chunked arrays.
numpy has no bfloat16, so a ``bfloat16`` array comes back as a
``torch.bfloat16`` tensor. Arrays are read with ``np.frombuffer`` on slices
of the file's bytes, without a copy per element; a truncated or trailing
byte raises ``ValueError``.

``dumps`` writes the same encoding (dicts, lists, tuples,
str, bytes, int, float, bool, None, numpy arrays and scalars, torch
tensors; maps in their insertion order), byte for byte as flax's
``to_bytes`` writes a dict tree. No entry point writes ``.msgpack``; the
encoder exists for the tests and the smoke test on the card, which has no
flax.
"""

from __future__ import annotations

import struct
from typing import Any, List

import numpy as np
import torch

MAX_CHUNK_SIZE = 2**30          # flax.serialization.MAX_CHUNK_SIZE
_CHUNKED = "__msgpack_chunked_array__"
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


# ------------------------------------------------------------------ decoding
class _Reader:
    def __init__(self, data):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError(f"msgpack data truncated: {n} bytes wanted at offset "
                             f"{self.pos} of {len(self.buf)}")
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        op = _OPS.get(b)
        if op is None:
            raise ValueError(f"msgpack: byte 0x{b:02x} at offset {self.pos - 1} is no type")
        return op(self)

    def str(self, n: int) -> str:
        return str(self.take(n), "utf-8")

    def array(self, n: int) -> List[Any]:
        return [self.read() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out

    def ext(self, n: int) -> Any:
        code = self.unpack(">b")
        return _ext(code, self.take(n))


def _sized(kind: str, fmt: str):
    return lambda r: getattr(r, kind)(r.unpack(fmt))


_OPS = {
    0xC0: lambda r: None, 0xC2: lambda r: False, 0xC3: lambda r: True,
    0xC4: lambda r: bytes(r.take(r.unpack(">B"))),
    0xC5: lambda r: bytes(r.take(r.unpack(">H"))),
    0xC6: lambda r: bytes(r.take(r.unpack(">I"))),
    0xC7: _sized("ext", ">B"), 0xC8: _sized("ext", ">H"), 0xC9: _sized("ext", ">I"),
    0xCA: lambda r: r.unpack(">f"), 0xCB: lambda r: r.unpack(">d"),
    0xCC: lambda r: r.unpack(">B"), 0xCD: lambda r: r.unpack(">H"),
    0xCE: lambda r: r.unpack(">I"), 0xCF: lambda r: r.unpack(">Q"),
    0xD0: lambda r: r.unpack(">b"), 0xD1: lambda r: r.unpack(">h"),
    0xD2: lambda r: r.unpack(">i"), 0xD3: lambda r: r.unpack(">q"),
    0xD4: lambda r: r.ext(1), 0xD5: lambda r: r.ext(2), 0xD6: lambda r: r.ext(4),
    0xD7: lambda r: r.ext(8), 0xD8: lambda r: r.ext(16),
    0xD9: _sized("str", ">B"), 0xDA: _sized("str", ">H"), 0xDB: _sized("str", ">I"),
    0xDC: _sized("array", ">H"), 0xDD: _sized("array", ">I"),
    0xDE: _sized("map", ">H"), 0xDF: _sized("map", ">I"),
}


def _array_from(payload: memoryview):
    """flax's ``_ndarray_from_bytes``: [shape, dtype name, bytes] → array."""
    r = _Reader(payload)
    head = r.take(1)[0]
    if head & 0xF0 != 0x90 or head & 0x0F != 3:
        raise ValueError("msgpack ndarray ext: expected a 3-element array")
    shape, name = r.read(), r.read()
    # the buffer is read as a view of the file's bytes, not copied
    b = r.take(1)[0]
    n = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}.get(b)
    if n is None:
        raise ValueError("msgpack ndarray ext: the array's bytes are not a bin")
    raw = r.take(r.unpack(n))
    if r.pos != len(r.buf):
        raise ValueError("msgpack ndarray ext: trailing bytes")
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":
        return torch.frombuffer(bytearray(raw), dtype=torch.bfloat16).reshape(shape)
    return np.frombuffer(raw, dtype=np.dtype(name)).reshape(shape)


def _ext(code: int, payload: memoryview) -> Any:
    if code == _EXT_NDARRAY:
        return _array_from(payload)
    if code == _EXT_NPSCALAR:
        a = _array_from(payload)
        return a.item() if torch.is_tensor(a) else a[()]
    if code == _EXT_COMPLEX:
        re, im = _Reader(payload).read()
        return complex(re, im)
    raise ValueError(f"msgpack: ext type {code} is not one of flax's")


def _unchunk(tree: Any) -> Any:
    if not isinstance(tree, dict):
        return tree
    if tree.get(_CHUNKED) is True:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        if torch.is_tensor(chunks[0]):
            return torch.cat(chunks).reshape(shape)
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def loads(data) -> Any:
    """Decode one msgpack object (bytes or a buffer) in flax's layout."""
    r = _Reader(data)
    tree = r.read()
    if r.pos != len(r.buf):
        raise ValueError(f"msgpack: {len(r.buf) - r.pos} bytes after the object")
    return _unchunk(tree)


def load(path: str) -> Any:
    """``loads`` of the file at ``path`` (cmh_tpu's ``model-N.msgpack``)."""
    with open(path, "rb") as f:
        return loads(f.read())


# ------------------------------------------------------------------ encoding
def _head(out: List[bytes], n: int, fix: int, fix_max: int, codes) -> None:
    if n <= fix_max and fix is not None:
        out.append(bytes([fix | n]))
        return
    for code, fmt, top in codes:
        if n < top:
            out.append(bytes([code]) + struct.pack(fmt, n))
            return
    raise ValueError(f"msgpack: length {n} too large")


_STR = ((0xD9, ">B", 1 << 8), (0xDA, ">H", 1 << 16), (0xDB, ">I", 1 << 32))
_BIN = ((0xC4, ">B", 1 << 8), (0xC5, ">H", 1 << 16), (0xC6, ">I", 1 << 32))
_ARR = ((0xDC, ">H", 1 << 16), (0xDD, ">I", 1 << 32))
_MAP = ((0xDE, ">H", 1 << 16), (0xDF, ">I", 1 << 32))


def _int(out: List[bytes], v: int) -> None:
    if 0 <= v <= 0x7F or -32 <= v < 0:
        out.append(struct.pack(">b" if v < 0 else ">B", v))
    elif v >= 0:
        for code, fmt, top in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                               (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if v < top:
                out.append(bytes([code]) + struct.pack(fmt, v))
                return
        raise ValueError(f"msgpack: int {v} too large")
    else:
        for code, fmt, low in ((0xD0, ">b", -(1 << 7)), (0xD1, ">h", -(1 << 15)),
                               (0xD2, ">i", -(1 << 31)), (0xD3, ">q", -(1 << 63))):
            if v >= low:
                out.append(bytes([code]) + struct.pack(fmt, v))
                return
        raise ValueError(f"msgpack: int {v} too small")


def _ext_out(out: List[bytes], code: int, payload: List[bytes]) -> None:
    n = sum(len(p) for p in payload)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(bytes([fixed[n]]))
    else:
        _head(out, n, None, -1, ((0xC7, ">B", 1 << 8), (0xC8, ">H", 1 << 16),
                                 (0xC9, ">I", 1 << 32)))
    out.append(struct.pack(">b", code))
    out.extend(payload)


def _array_payload(a) -> List[bytes]:
    """flax's ``_ndarray_to_bytes``: msgpack of (shape, dtype name, bytes)."""
    if torch.is_tensor(a):
        t = a.detach().cpu().contiguous()
        name = "bfloat16" if t.dtype == torch.bfloat16 else str(t.numpy().dtype)
        raw = t.view(torch.int16).numpy().tobytes() if t.dtype == torch.bfloat16 \
            else t.numpy().tobytes()
        shape = tuple(t.shape)
    else:
        a = np.asarray(a)
        name, raw, shape = a.dtype.name, a.tobytes("C"), a.shape
    out: List[bytes] = [b"\x93"]
    _encode(out, list(shape))
    _encode(out, name)
    _head(out, len(raw), None, -1, _BIN)
    out.append(raw)
    return out


def _chunked(a) -> dict:
    """flax's ``_chunk``: an array above ``MAX_CHUNK_SIZE`` bytes as chunks."""
    itemsize = a.element_size() if torch.is_tensor(a) else a.dtype.itemsize
    step = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = a.reshape(-1)
    n = flat.numel() if torch.is_tensor(a) else flat.size
    return {_CHUNKED: True, "shape": {str(i): int(s) for i, s in enumerate(a.shape)},
            "chunks": {str(i): flat[s:s + step]
                       for i, s in enumerate(range(0, n, step))}}


def _encode(out: List[bytes], v: Any) -> None:
    if v is None:
        out.append(b"\xc0")
    elif v is True or v is False:
        out.append(b"\xc3" if v else b"\xc2")
    elif isinstance(v, (np.ndarray, torch.Tensor)):
        nbytes = v.numel() * v.element_size() if torch.is_tensor(v) else v.nbytes
        if nbytes > MAX_CHUNK_SIZE:
            _encode(out, _chunked(v))
        else:
            _ext_out(out, _EXT_NDARRAY, _array_payload(v))
    elif isinstance(v, np.generic):
        _ext_out(out, _EXT_NPSCALAR, _array_payload(np.asarray(v)))
    elif isinstance(v, int):
        _int(out, v)
    elif isinstance(v, float):
        out.append(b"\xcb" + struct.pack(">d", v))
    elif isinstance(v, complex):
        payload: List[bytes] = [b"\x92"]
        _encode(payload, v.real)
        _encode(payload, v.imag)
        _ext_out(out, _EXT_COMPLEX, payload)
    elif isinstance(v, str):
        raw = v.encode()
        _head(out, len(raw), 0xA0, 31, _STR)
        out.append(raw)
    elif isinstance(v, (bytes, bytearray)):
        _head(out, len(v), None, -1, _BIN)
        out.append(bytes(v))
    elif isinstance(v, (list, tuple)):
        _head(out, len(v), 0x90, 15, _ARR)
        for x in v:
            _encode(out, x)
    elif isinstance(v, dict):
        _head(out, len(v), 0x80, 15, _MAP)
        for k, x in v.items():
            _encode(out, k)
            _encode(out, x)
    else:
        raise TypeError(f"msgpack: cannot encode {type(v).__name__}")


def dumps(tree: Any) -> bytes:
    """``tree`` in flax's msgpack layout (``flax.serialization.to_bytes``)."""
    out: List[bytes] = []
    _encode(out, tree)
    return b"".join(out)
