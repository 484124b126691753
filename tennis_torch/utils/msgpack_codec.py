"""flax's msgpack checkpoint format, encoded and decoded in pure Python.

The subset that ``flax.serialization.msgpack_serialize`` writes and
``msgpack_restore`` reads: maps with str keys, arrays, str, bin, int, float,
bool and nil, and the ext types

- 1, an ndarray: the payload is itself msgpack, ``(shape, dtype name,
  C-order bytes)``;
- 3, a numpy scalar: an ndarray payload of shape ``()``;
- 2, a complex ``(real, imag)``, read only.

An array leaf of more than ``MAX_CHUNK_SIZE`` bytes is written as a dict
``{"__msgpack_chunked_array__": True, "shape": {"0": ..}, "chunks": {"0":
flat chunk, ..}}``, as flax writes it, and read back whole.

:func:`serialize` writes each dict in its iteration order, as flax's
``to_bytes`` does (``msgpack_serialize`` without ``in_place`` first sorts
the keys), choosing every format as the ``msgpack`` package does, so the
bytes equal flax's. Leaves may be numpy arrays or scalars, or torch tensors
(a bf16 tensor is written as flax writes a ``bfloat16`` array). :func:`restore`
returns nested dicts, lists and numpy arrays; numpy has no bfloat16, so a
bf16 leaf is widened to f32.
"""
from __future__ import annotations

import struct

import numpy as np
import torch

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
CHUNKED = "__msgpack_chunked_array__"
MAX_CHUNK_SIZE = 2 ** 30  # bytes; flax's margin under msgpack's 2**31 - 1


class DecodeError(ValueError):
    """The bytes are not a well-formed checkpoint."""


# ------------------------------------------------------------------ encoding


def _pack_int(out: list, n: int):
    """The smallest form, as the ``msgpack`` package picks it: a fixint for
    -32..127, else the narrowest signed form below 0, unsigned above."""
    if -(1 << 5) <= n < (1 << 7):
        out.append(struct.pack(">b", n))
        return
    forms = ((0xd0, ">Bb", 7), (0xd1, ">Bh", 15), (0xd2, ">Bi", 31),
             (0xd3, ">Bq", 63)) if n < 0 else \
        ((0xcc, ">BB", 8), (0xcd, ">BH", 16), (0xce, ">BI", 32),
         (0xcf, ">BQ", 64))
    for code, fmt, bits in forms:
        if (n >= -(1 << bits)) if n < 0 else (n < (1 << bits)):
            out.append(struct.pack(fmt, code, n))
            return
    raise OverflowError(f"int {n} does not fit in msgpack")


def _pack_len(out: list, n: int, fix: int | None, fix_max: int, codes):
    """A length header: the fix form below ``fix_max``, else the 8- (if
    ``codes`` has three), 16- or 32-bit form."""
    if fix is not None and n < fix_max:
        out.append(bytes([fix | n]))
        return
    forms = list(zip(codes, (">BB", ">BH", ">BI")[3 - len(codes):]))
    for code, fmt in forms:
        if n < 1 << (8 * struct.calcsize(fmt[2:])):
            out.append(struct.pack(fmt, code, n))
            return
    raise ValueError(f"length {n} does not fit in msgpack")


def _pack_ext(out: list, code: int, data: bytes):
    n = len(data)
    fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if n in fixed:
        out.append(bytes([fixed[n]]))
    else:
        _pack_len(out, n, None, 0, (0xc7, 0xc8, 0xc9))
    out.append(struct.pack(">b", code))
    out.append(data)


def _array_parts(x):
    """(shape, dtype name, C-order bytes) of a numpy array or torch tensor."""
    if isinstance(x, np.ndarray):
        if x.dtype.hasobject or x.dtype.isalignedstruct:
            raise ValueError("object and structured dtypes are not supported")
        return x.shape, x.dtype.name, x.tobytes("C")
    t = x.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return tuple(t.shape), "bfloat16", t.view(torch.int16).numpy().tobytes()
    a = t.numpy()
    return a.shape, a.dtype.name, a.tobytes()


def _ndarray_bytes(x) -> bytes:
    shape, name, data = _array_parts(x)
    out: list = []
    _pack(out, [list(shape), name, data])
    return b"".join(out)


def _pack(out: list, x):
    if x is None:
        out.append(b"\xc0")
    elif x is True or x is False:
        out.append(b"\xc3" if x else b"\xc2")
    elif type(x) is int:
        _pack_int(out, x)
    elif type(x) is float:
        out.append(struct.pack(">Bd", 0xcb, x))
    elif type(x) is str:
        data = x.encode("utf-8")
        _pack_len(out, len(data), 0xa0, 32, (0xd9, 0xda, 0xdb))
        out.append(data)
    elif type(x) in (bytes, bytearray, memoryview):
        data = bytes(x)
        _pack_len(out, len(data), None, 0, (0xc4, 0xc5, 0xc6))
        out.append(data)
    elif type(x) in (list, tuple):
        _pack_len(out, len(x), 0x90, 16, (0xdc, 0xdd))
        for v in x:
            _pack(out, v)
    elif type(x) is dict:
        _pack_len(out, len(x), 0x80, 16, (0xde, 0xdf))
        for k, v in x.items():
            if type(k) is not str:
                raise TypeError(f"map keys must be str, not {type(k).__name__}")
            _pack(out, k)
            _pack(out, v)
    elif isinstance(x, (np.ndarray, torch.Tensor)):
        _pack_ext(out, EXT_NDARRAY, _ndarray_bytes(x))
    elif isinstance(x, np.generic):
        _pack_ext(out, EXT_NPSCALAR, _ndarray_bytes(np.asarray(x)))
    else:
        raise TypeError(f"cannot serialize {type(x).__name__}")


def _nbytes(x) -> int:
    if isinstance(x, np.ndarray):
        return x.nbytes
    return x.numel() * x.element_size()


def _chunk(x) -> dict:
    """flax's chunked form of an oversized array leaf."""
    itemsize = _nbytes(x) // max(1, int(np.prod(x.shape)))
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = x.reshape(-1)
    n = int(np.prod(x.shape))
    return {CHUNKED: True,
            "shape": {str(i): int(d) for i, d in enumerate(x.shape)},
            "chunks": {str(i): flat[s:s + size]
                       for i, s in enumerate(range(0, n, size))}}


def _chunk_leaves(tree):
    """Replace each oversized array leaf of a dict tree (or the tree itself,
    when it is one array) by its chunked form; other containers as they are."""
    def big(x):
        return isinstance(x, (np.ndarray, torch.Tensor)) and \
            _nbytes(x) > MAX_CHUNK_SIZE

    if isinstance(tree, dict):
        return {k: _chunk(v) if big(v) else _chunk_leaves(v)
                for k, v in tree.items()}
    return _chunk(tree) if big(tree) else tree


def serialize(tree) -> bytes:
    """msgpack bytes of ``tree``, as flax's ``to_bytes`` writes them."""
    out: list = []
    _pack(out, _chunk_leaves(tree))
    return b"".join(out)


# ------------------------------------------------------------------ decoding


class _Reader:
    def __init__(self, data: bytes, str_as_bytes: bool = False):
        self.data, self.pos, self.str_as_bytes = data, 0, str_as_bytes

    def take(self, n: int) -> bytes:
        end = self.pos + n
        if end > len(self.data):
            raise DecodeError("truncated msgpack data")
        chunk = self.data[self.pos:end]
        self.pos = end
        return chunk

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def str_(self, n: int):
        raw = self.take(n)
        return raw if self.str_as_bytes else raw.decode("utf-8")

    def ext(self, n: int):
        code = self.unpack(">b")
        return _from_ext(code, self.take(n))

    def value(self):
        b = self.unpack(">B")
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map_(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return [self.value() for _ in range(b & 0x0f)]
        if 0xa0 <= b <= 0xbf:
            return self.str_(b & 0x1f)
        simple = {0xc0: None, 0xc2: False, 0xc3: True}
        if b in simple:
            return simple[b]
        ints = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q",
                0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q",
                0xca: ">f", 0xcb: ">d"}
        if b in ints:
            v = self.unpack(ints[b])
            return float(v) if b in (0xca, 0xcb) else v
        lens = {0xc4: ">B", 0xc5: ">H", 0xc6: ">I",   # bin
                0xd9: ">B", 0xda: ">H", 0xdb: ">I",   # str
                0xdc: ">H", 0xdd: ">I",               # array
                0xde: ">H", 0xdf: ">I",               # map
                0xc7: ">B", 0xc8: ">H", 0xc9: ">I"}   # ext
        if b in lens:
            n = self.unpack(lens[b])
            if b <= 0xc6:
                return self.take(n)
            if b <= 0xc9:
                return self.ext(n)
            if b <= 0xdb:
                return self.str_(n)
            if b <= 0xdd:
                return [self.value() for _ in range(n)]
            return self.map_(n)
        fixext = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        raise DecodeError(f"unknown msgpack type byte 0x{b:02x}")

    def map_(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out


def _ndarray_from_bytes(data: bytes) -> np.ndarray:
    shape, dtype_name, buffer = _Reader(data, str_as_bytes=True).value()
    if dtype_name == b"bfloat16":  # numpy has no bfloat16: widen to f32
        raw = np.frombuffer(buffer, dtype=np.uint16).astype(np.uint32)
        return (raw << 16).view(np.float32).reshape(shape)
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode())) \
        .reshape(shape)


def _from_ext(code: int, data: bytes):
    if code == EXT_NDARRAY:
        return _ndarray_from_bytes(data)
    if code == EXT_NPSCALAR:
        return _ndarray_from_bytes(data)[()]
    if code == EXT_COMPLEX:
        re_, im = _Reader(data).value()
        return complex(re_, im)
    raise DecodeError(f"unknown msgpack ext type {code}")


def _unchunk(tree):
    if isinstance(tree, dict):
        if CHUNKED in tree:
            shape = tuple(tree["shape"][str(i)]
                          for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def restore(data: bytes):
    """The tree ``data`` encodes; :class:`DecodeError` if it encodes none."""
    reader = _Reader(bytes(data))
    try:
        tree = reader.value()
        if reader.pos != len(reader.data):
            raise DecodeError(f"{len(reader.data) - reader.pos} bytes past "
                              f"the end of the msgpack data")
        return _unchunk(tree)
    except DecodeError:
        raise
    except (ValueError, TypeError, KeyError, UnicodeDecodeError,
            struct.error) as e:
        raise DecodeError(f"malformed checkpoint: {type(e).__name__}: {e}") \
            from e
