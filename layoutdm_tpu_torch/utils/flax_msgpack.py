"""Read the files ``flax.serialization.to_bytes`` writes, without flax or
the ``msgpack`` package (neither is on the GPU host).

Such a file is one msgpack value: maps with string keys, holding ints,
floats, strings, bytes and the ext types flax registers: 1, an ndarray
encoded as the msgpack array ``(shape, dtype name, C-order bytes)``, and 3,
a numpy scalar encoded the same way.  ``read_flax_msgpack`` returns it as
nested dicts of numpy arrays, e.g. the params of a JAX FIDNet checkpoint
(``model_best.msgpack``) for ``eval.fidnet.fidnet_params_from_flax``.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3

# fixed-width formats, by leading byte: (struct format, size)
_FIXED = {
    0xCA: (">f", 4), 0xCB: (">d", 8),
    0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
    0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
}
# length-prefixed kinds, by leading byte: (kind, width of the length)
_SIZED = {
    0xC4: ("bin", 1), 0xC5: ("bin", 2), 0xC6: ("bin", 4),
    0xC7: ("ext", 1), 0xC8: ("ext", 2), 0xC9: ("ext", 4),
    0xD9: ("str", 1), 0xDA: ("str", 2), 0xDB: ("str", 4),
    0xDC: ("array", 2), 0xDD: ("array", 4),
    0xDE: ("map", 2), 0xDF: ("map", 4),
}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
_UINT = {1: ">B", 2: ">H", 4: ">I"}


def _ndarray(data: bytes) -> np.ndarray:
    shape, dtype, buf = unpackb(data)
    return np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape).copy()


def _ext(code: int, data: bytes) -> Any:
    if code == _EXT_NDARRAY:
        return _ndarray(data)
    if code == _EXT_NPSCALAR:
        return _ndarray(data)[()]
    raise ValueError(f"msgpack ext type {code} is not one flax writes for arrays")


def _unpack(buf: bytes, pos: int) -> Tuple[Any, int]:
    b = buf[pos]
    pos += 1
    if b <= 0x7F:
        return b, pos
    if b >= 0xE0:
        return b - 0x100, pos
    if 0x80 <= b <= 0x8F:
        return _container("map", b & 0x0F, buf, pos)
    if 0x90 <= b <= 0x9F:
        return _container("array", b & 0x0F, buf, pos)
    if 0xA0 <= b <= 0xBF:
        n = b & 0x1F
        return buf[pos:pos + n].decode("utf-8"), pos + n
    if b == 0xC0:
        return None, pos
    if b in (0xC2, 0xC3):
        return b == 0xC3, pos
    if b in _FIXED:
        fmt, size = _FIXED[b]
        return struct.unpack_from(fmt, buf, pos)[0], pos + size
    if b in _FIXEXT:
        n = _FIXEXT[b]
        code = struct.unpack_from(">b", buf, pos)[0]
        return _ext(code, buf[pos + 1:pos + 1 + n]), pos + 1 + n
    if b in _SIZED:
        kind, width = _SIZED[b]
        n = struct.unpack_from(_UINT[width], buf, pos)[0]
        pos += width
        if kind in ("map", "array"):
            return _container(kind, n, buf, pos)
        if kind == "ext":
            code = struct.unpack_from(">b", buf, pos)[0]
            return _ext(code, buf[pos + 1:pos + 1 + n]), pos + 1 + n
        data = buf[pos:pos + n]
        return (data.decode("utf-8") if kind == "str" else data), pos + n
    raise ValueError(f"msgpack byte 0x{b:02x} at offset {pos - 1} is not supported")


def _container(kind: str, n: int, buf: bytes, pos: int) -> Tuple[Any, int]:
    if kind == "array":
        out = []
        for _ in range(n):
            v, pos = _unpack(buf, pos)
            out.append(v)
        return out, pos
    out = {}
    for _ in range(n):
        k, pos = _unpack(buf, pos)
        out[k], pos = _unpack(buf, pos)
    return out, pos


def unpackb(data: bytes) -> Any:
    """One msgpack value from ``data``, which it must fill exactly."""
    buf = bytes(data)
    value, end = _unpack(buf, 0)
    if end != len(buf):
        raise ValueError(f"{len(buf) - end} trailing bytes after the msgpack value")
    return value


def read_flax_msgpack(path: str) -> Any:
    """The state a ``flax.serialization.to_bytes`` file holds, as nested
    dicts of numpy arrays."""
    with open(path, "rb") as f:
        return unpackb(f.read())
