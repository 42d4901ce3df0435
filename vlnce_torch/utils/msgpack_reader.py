"""A decode-only reader of the msgpack files the JAX package writes.

The JAX package saves checkpoints with `flax.serialization.msgpack_serialize`
(vlnce_tpu/utils/checkpoints.py). This module reads the subset of msgpack
that flax writes, with no dependency beyond numpy:

- nil, bool, ints, floats, str, bin, arrays and maps;
- flax's ext types (`flax.serialization._MsgpackExtType`): 1 an ndarray,
  packed as the msgpack array `(shape, dtype name, bytes)`; 2 a Python
  complex, packed as `(real, imag)`; 3 a numpy scalar, packed as an ndarray
  of shape ();
- flax's chunked leaves, the arrays over `MAX_CHUNK_SIZE` bytes, which flax
  writes as a map `{"__msgpack_chunked_array__": True, "shape": {"0": ...},
  "chunks": {"0": ..., ...}}` and `unpackb` reassembles into one array.

The result equals `flax.serialization.msgpack_restore` of the same bytes:
msgpack arrays come back as lists, str as str, bin as bytes. One exception:
numpy has no bfloat16, so a bfloat16 ndarray comes back as float32, which
holds every bfloat16 value exactly. Arrays are copies, so they are writable.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"

# fixed-width scalars: type byte -> struct format (big-endian)
_SCALARS = {
    0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
    0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
}
# length-prefixed types: type byte -> (kind, width of the length field)
_SIZED = {
    0xC4: ("bin", 1), 0xC5: ("bin", 2), 0xC6: ("bin", 4),
    0xC7: ("ext", 1), 0xC8: ("ext", 2), 0xC9: ("ext", 4),
    0xD9: ("str", 1), 0xDA: ("str", 2), 0xDB: ("str", 4),
    0xDC: ("array", 2), 0xDD: ("array", 4), 0xDE: ("map", 2), 0xDF: ("map", 4),
}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
_UINT = {1: ">B", 2: ">H", 4: ">I"}


def _ndarray(data: bytes) -> np.ndarray:
    shape, dtype_name, buffer = unpackb(data, chunked=False)
    name = dtype_name.decode() if isinstance(dtype_name, bytes) else dtype_name
    if name == "bfloat16":  # the upper half of a float32's bits
        bits = np.frombuffer(buffer, dtype="<u2").astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buffer, dtype=np.dtype(name)).reshape(shape).copy()


def _ext(code: int, data: bytes) -> Any:
    if code == EXT_NDARRAY:
        return _ndarray(data)
    if code == EXT_NPSCALAR:
        return _ndarray(data)[()]
    if code == EXT_COMPLEX:
        real, imag = unpackb(data, chunked=False)
        return complex(real, imag)
    raise ValueError(f"msgpack ext type {code} is not one that flax writes")


def _read(buf: memoryview, pos: int) -> Tuple[Any, int]:
    b = buf[pos]
    pos += 1
    if b <= 0x7F:
        return b, pos
    if b >= 0xE0:
        return b - 0x100, pos
    if 0x80 <= b <= 0x8F:
        return _read_map(buf, pos, b & 0x0F)
    if 0x90 <= b <= 0x9F:
        return _read_array(buf, pos, b & 0x0F)
    if 0xA0 <= b <= 0xBF:
        n = b & 0x1F
        return str(buf[pos:pos + n], "utf-8"), pos + n
    if b == 0xC0:
        return None, pos
    if b in (0xC2, 0xC3):
        return b == 0xC3, pos
    if b in _SCALARS:
        fmt = _SCALARS[b]
        return struct.unpack_from(fmt, buf, pos)[0], pos + struct.calcsize(fmt)
    if b in _FIXEXT:
        n = _FIXEXT[b]
        code = struct.unpack_from(">b", buf, pos)[0]
        return _ext(code, bytes(buf[pos + 1:pos + 1 + n])), pos + 1 + n
    if b in _SIZED:
        kind, width = _SIZED[b]
        n = struct.unpack_from(_UINT[width], buf, pos)[0]
        pos += width
        if kind == "array":
            return _read_array(buf, pos, n)
        if kind == "map":
            return _read_map(buf, pos, n)
        if kind == "ext":
            code = struct.unpack_from(">b", buf, pos)[0]
            return _ext(code, bytes(buf[pos + 1:pos + 1 + n])), pos + 1 + n
        raw = bytes(buf[pos:pos + n])
        return (raw.decode("utf-8") if kind == "str" else raw), pos + n
    raise ValueError(f"msgpack type byte 0x{b:02x} at offset {pos - 1} is not one that flax writes")


def _read_array(buf, pos, n):
    out = []
    for _ in range(n):
        v, pos = _read(buf, pos)
        out.append(v)
    return out, pos


def _read_map(buf, pos, n):
    out = {}
    for _ in range(n):
        k, pos = _read(buf, pos)
        v, pos = _read(buf, pos)
        out[tuple(k) if isinstance(k, list) else k] = v
    return out, pos


def _unchunk(node: Any) -> Any:
    """Flax's chunked leaves back into arrays, anywhere in the tree."""
    if not isinstance(node, dict):
        return node
    if _CHUNKED in node:
        shape = tuple(node["shape"][str(i)] for i in range(len(node["shape"])))
        chunks = [node["chunks"][str(i)] for i in range(len(node["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in node.items()}


def unpackb(data: bytes, chunked: bool = True) -> Any:
    """The object msgpack-encoded in `data`, with flax's chunked arrays
    reassembled (`chunked`) as `flax.serialization.msgpack_restore` does."""
    buf = memoryview(data)
    obj, pos = _read(buf, 0)
    if pos != len(buf):
        raise ValueError(f"msgpack: {len(buf) - pos} trailing bytes after the object")
    return _unchunk(obj) if chunked else obj
