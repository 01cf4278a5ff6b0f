"""Reader and writer of the msgpack that ``flax.serialization`` writes, in
pure Python (no ``msgpack``, ``flax`` or JAX needed).

The JAX package's checkpoints are Flax msgpack: a ``--weight_dump`` is the
msgpack of the ``params`` tree, and a model dump or snapshot pickles it
around the msgpack of the whole train state.  This module covers the
subset of msgpack that ``flax.serialization.msgpack_serialize`` writes:

- maps (string keys), arrays, ints, floats, bools, nil, str and bin;
- the ext types of ``flax/serialization.py``: an ndarray (code 1), whose
  payload is the msgpack triple (shape, dtype name, C-order bytes); a
  native complex (code 2), the pair (real, imag); a numpy scalar (code 3),
  packed as a 0-d ndarray;
- the ``__msgpack_chunked_array__`` maps that flax writes for a leaf of more
  than :data:`MAX_CHUNK_SIZE` bytes.

numpy has no bfloat16, so a ``bfloat16`` leaf comes back as a
``torch.bfloat16`` tensor (read through a ``uint16`` view) and is written
from one.  Array payloads are sliced out of one ``memoryview``: they are
never walked byte by byte, and a restored array is a read-only view of the
input bytes, as flax's ``np.frombuffer`` is.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

#: flax's ``MAX_CHUNK_SIZE``: a leaf of more bytes is written as chunks
MAX_CHUNK_SIZE = 2**30
_CHUNKED = "__msgpack_chunked_array__"
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


# -- reading ---------------------------------------------------------------

class _Reader:
    """Decodes one msgpack object after another from a ``memoryview``."""

    def __init__(self, data):
        self.buf = memoryview(data).cast("B")
        self.pos = 0

    def take(self, n):
        start, self.pos = self.pos, self.pos + n
        if self.pos > len(self.buf):
            raise ValueError("truncated msgpack data")
        return self.buf[start:self.pos]

    def unpack(self, fmt):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self.take(size))[0]

    def read(self, raw=False):
        """The next object; with ``raw``, str and bin come back as
        ``memoryview`` slices (the ndarray payload's fields)."""
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.read_map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.read(raw) for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.read_str(b & 0x1F, raw)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in (0xC4, 0xC5, 0xC6):  # bin 8 / 16 / 32
            n = self.unpack((">B", ">H", ">I")[b - 0xC4])
            data = self.take(n)
            return data if raw else bytes(data)
        if b in (0xC7, 0xC8, 0xC9):  # ext 8 / 16 / 32
            n = self.unpack((">B", ">H", ">I")[b - 0xC7])
            code = self.unpack(">b")
            return _ext(code, self.take(n))
        if b == 0xCA:
            return self.unpack(">f")
        if b == 0xCB:
            return self.unpack(">d")
        if 0xCC <= b <= 0xD3:  # uint 8-64, int 8-64
            return self.unpack((">B", ">H", ">I", ">Q", ">b", ">h", ">i", ">q")[b - 0xCC])
        if 0xD4 <= b <= 0xD8:  # fixext 1 / 2 / 4 / 8 / 16
            code = self.unpack(">b")
            return _ext(code, self.take(1 << (b - 0xD4)))
        if b in (0xD9, 0xDA, 0xDB):  # str 8 / 16 / 32
            return self.read_str(self.unpack((">B", ">H", ">I")[b - 0xD9]), raw)
        if b in (0xDC, 0xDD):  # array 16 / 32
            return [self.read(raw) for _ in range(self.unpack(">H" if b == 0xDC else ">I"))]
        if b in (0xDE, 0xDF):  # map 16 / 32
            return self.read_map(self.unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"msgpack byte 0x{b:02x} at {self.pos - 1} is not valid")

    def read_str(self, n, raw):
        data = self.take(n)
        return data if raw else str(data, "utf-8")

    def read_map(self, n):
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out


def _array(payload):
    """An ndarray ext payload -> a numpy array (a tensor for bfloat16)."""
    shape, name, data = _Reader(payload).read(raw=True)
    name = bytes(name).decode()
    if name == "bfloat16":
        bits = np.frombuffer(data, dtype=np.uint16).reshape(shape)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return np.frombuffer(data, dtype=np.dtype(name)).reshape(shape)


def _ext(code, payload):
    if code == _EXT_NDARRAY:
        return _array(payload)
    if code == _EXT_NPSCALAR:
        return _array(payload)[()]
    if code == _EXT_COMPLEX:
        real, imag = _Reader(payload).read()
        return complex(real, imag)
    raise ValueError(f"msgpack ext code {code} is not one that flax writes")


def _unchunk(d):
    """The array of one ``__msgpack_chunked_array__`` map."""
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    if isinstance(chunks[0], torch.Tensor):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def _unchunk_leaves(tree):
    """Replaces chunked leaves in maps, as flax's restore does."""
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            return _unchunk(tree)
        for key, value in tree.items():
            if isinstance(value, dict):
                tree[key] = _unchunk_leaves(value)
    return tree


def msgpack_restore(data):
    """The tree of ``flax.serialization.msgpack_restore(data)``: nested
    dicts and lists of Python scalars, numpy arrays and scalars, and
    ``torch.bfloat16`` tensors for bfloat16 leaves."""
    reader = _Reader(data)
    tree = reader.read()
    if reader.pos != len(reader.buf):
        raise ValueError(f"{len(reader.buf) - reader.pos} bytes after the msgpack object")
    return _unchunk_leaves(tree)


# -- writing ---------------------------------------------------------------

def _head(out, n, small, small_max, codes):
    """A str / bin / array / map / ext header: the fix form below
    ``small_max``, else the smallest of the 8-, 16- and 32-bit forms
    (``codes``; None where the type has no 8-bit form)."""
    if small is not None and n < small_max:
        out.append(small | n)
    elif codes[0] is not None and n < 1 << 8:
        out += struct.pack(">BB", codes[0], n)
    elif n < 1 << 16:
        out += struct.pack(">BH", codes[1], n)
    elif n < 1 << 32:
        out += struct.pack(">BI", codes[2], n)
    else:
        raise ValueError(f"{n} entries or bytes do not fit msgpack")


def _int(out, v):
    if 0 <= v < 0x80 or -32 <= v < 0:
        out += struct.pack(">b" if v < 0 else ">B", v)
    elif v >= 0:
        for code, fmt, top in ((0xCC, ">BB", 1 << 8), (0xCD, ">BH", 1 << 16),
                               (0xCE, ">BI", 1 << 32), (0xCF, ">BQ", 1 << 64)):
            if v < top:
                out += struct.pack(fmt, code, v)
                return
        raise OverflowError(f"{v} does not fit msgpack")
    else:
        for code, fmt, low in ((0xD0, ">Bb", -(1 << 7)), (0xD1, ">Bh", -(1 << 15)),
                               (0xD2, ">Bi", -(1 << 31)), (0xD3, ">Bq", -(1 << 63))):
            if v >= low:
                out += struct.pack(fmt, code, v)
                return
        raise OverflowError(f"{v} does not fit msgpack")


def _str(out, s):
    data = s.encode("utf-8")
    _head(out, len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB))
    out += data


def _bin(out, data):
    _head(out, len(data), None, 0, (0xC4, 0xC5, 0xC6))
    out += data


def _ext_record(out, code, payload):
    n = len(payload)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(fixed[n])
    else:
        _head(out, n, None, 0, (0xC7, 0xC8, 0xC9))
    out += struct.pack(">b", code)
    out += payload


def _array_parts(x):
    """(shape, dtype name, C-order bytes) of a numpy array or a tensor."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous()
        if x.dtype == torch.bfloat16:
            return tuple(x.shape), "bfloat16", x.view(torch.int16).numpy().tobytes()
        x = x.numpy()
    if x.dtype.hasobject or x.dtype.isalignedstruct:
        raise ValueError("Object and structured dtypes not supported "
                         "for serialization of ndarrays.")
    return x.shape, x.dtype.name, x.tobytes("C")


def _array_payload(x):
    shape, name, data = _array_parts(x)
    out = bytearray([0x93])  # the triple
    _head(out, len(shape), 0x90, 16, (None, 0xDC, 0xDD))
    for dim in shape:
        _int(out, int(dim))
    _str(out, name)
    _bin(out, data)
    return bytes(out)


def _pack(out, x):
    # the order of strict_types: exact bool, int, float; then numpy
    if x is None:
        out.append(0xC0)
    elif x is True or x is False:
        out.append(0xC3 if x else 0xC2)
    elif type(x) is int:
        _int(out, x)
    elif type(x) is float:
        out += struct.pack(">Bd", 0xCB, x)
    elif type(x) is str:
        _str(out, x)
    elif type(x) in (bytes, bytearray, memoryview):
        _bin(out, bytes(x))
    elif type(x) is dict:
        _head(out, len(x), 0x80, 16, (None, 0xDE, 0xDF))
        for key, value in x.items():
            _pack(out, key)
            _pack(out, value)
    elif type(x) is list:
        _head(out, len(x), 0x90, 16, (None, 0xDC, 0xDD))
        for value in x:
            _pack(out, value)
    elif isinstance(x, (np.ndarray, torch.Tensor)):
        _ext_record(out, _EXT_NDARRAY, _array_payload(x))
    elif isinstance(x, np.generic):
        _ext_record(out, _EXT_NPSCALAR, _array_payload(np.asarray(x)))
    elif type(x) is complex:
        payload = bytearray([0x92])
        payload += struct.pack(">BdBd", 0xCB, x.real, 0xCB, x.imag)
        _ext_record(out, _EXT_COMPLEX, bytes(payload))
    else:
        raise TypeError(f"can not serialize {type(x).__name__!r} object")


def _nbytes(x):
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else x.nbytes


def _chunk(x):
    """flax's chunked form of a large array leaf."""
    itemsize = x.element_size() if isinstance(x, torch.Tensor) else x.dtype.itemsize
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = x.reshape(-1)
    n = flat.shape[0]
    return {_CHUNKED: True,
            "shape": {str(i): int(d) for i, d in enumerate(x.shape)},
            "chunks": {str(i): flat[start:start + size]
                       for i, start in enumerate(range(0, n, size))}}


def _chunked(tree, chunk=True):
    """A copy of ``tree`` with, as flax has it, large array leaves chunked
    at the top and in maps reached through maps only."""
    if isinstance(tree, dict):
        return {key: _chunked(value, chunk) for key, value in tree.items()}
    if isinstance(tree, list):
        return [_chunked(v, chunk=False) for v in tree]
    if (chunk and isinstance(tree, (np.ndarray, torch.Tensor))
            and _nbytes(tree) > MAX_CHUNK_SIZE):
        return _chunk(tree)
    return tree


def sorted_tree(tree):
    """A copy of ``tree`` with every dict's keys sorted, as the copy that
    ``jax.tree_util.tree_map`` (and ``jax.device_get``) makes."""
    if isinstance(tree, dict):
        return {key: sorted_tree(tree[key]) for key in sorted(tree)}
    if isinstance(tree, list):
        return [sorted_tree(v) for v in tree]
    return tree


def msgpack_serialize(tree, in_place=False):
    """The bytes ``flax.serialization.msgpack_serialize(tree, in_place)``
    writes for a tree of dicts and lists with Python scalars, numpy arrays
    and scalars (or tensors) as leaves.  Without ``in_place`` flax copies
    the tree with ``jax.tree_util.tree_map``, which sorts every dict's keys;
    with it the dicts keep their order (what ``flax.serialization.to_bytes``
    writes for a tree whose dicts are sorted already)."""
    out = bytearray()
    _pack(out, _chunked(tree if in_place else sorted_tree(tree)))
    return bytes(out)
