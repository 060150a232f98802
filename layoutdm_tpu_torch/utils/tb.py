"""Minimal TensorBoard events writer — no tensorflow/tensorboard dependency.

The reference logs per-iter scalars and sample-image grids to TensorBoard
(`main.py:241-243,135-142`).  Our canonical log is `metrics.jsonl`; this
module bridges the same values into the TFRecord/Event wire format that
`tensorboard --logdir` reads, hand-encoding the two tiny protos involved:

    Event    { double wall_time = 1; int64 step = 2; Summary summary = 5; }
    Summary  { repeated Value value = 1; }
    Value    { string tag = 1; float simple_value = 2; Image image = 4; }
    Image    { int32 height = 1; int32 width = 2; int32 colorspace = 3;
               bytes encoded_image_string = 4; }

and the TFRecord framing (length + masked crc32c of length, payload,
masked crc32c of payload).
"""

from __future__ import annotations

import os
import struct
import time
from typing import Optional

# ---------------------------------------------------------------------------
# crc32c (Castagnoli), table-driven
# ---------------------------------------------------------------------------

_CRC_TABLE = []


def _make_table():
    poly = 0x82F63B78
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        _CRC_TABLE.append(c)


_make_table()


def crc32c(data: bytes) -> int:
    c = 0xFFFFFFFF
    for b in data:
        c = _CRC_TABLE[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# protobuf wire helpers (varint + length-delimited only)
# ---------------------------------------------------------------------------


def _varint(n: int) -> bytes:
    out = b""
    while True:
        b7 = n & 0x7F
        n >>= 7
        if n:
            out += bytes([b7 | 0x80])
        else:
            out += bytes([b7])
            return out


def _key(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _bytes_field(field: int, payload: bytes) -> bytes:
    return _key(field, 2) + _varint(len(payload)) + payload


def _double_field(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def _float_field(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _varint_field(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(v)


def _encode_event(
    step: int,
    wall_time: Optional[float] = None,
    summary: Optional[bytes] = None,
    file_version: Optional[str] = None,
) -> bytes:
    ev = _double_field(1, wall_time if wall_time is not None else time.time())
    ev += _varint_field(2, step)
    if file_version is not None:
        ev += _bytes_field(3, file_version.encode())
    if summary is not None:
        ev += _bytes_field(5, summary)
    return ev


def _scalar_summary(tag: str, value: float) -> bytes:
    v = _bytes_field(1, tag.encode()) + _float_field(2, float(value))
    return _bytes_field(1, v)


def _image_summary(tag: str, png: bytes, h: int, w: int) -> bytes:
    img = (
        _varint_field(1, h)
        + _varint_field(2, w)
        + _varint_field(3, 3)  # RGB
        + _bytes_field(4, png)
    )
    v = _bytes_field(1, tag.encode()) + _bytes_field(4, img)
    return _bytes_field(1, v)


class EventsWriter:
    """Append-only `events.out.tfevents.*` file (`tensorboard --logdir` UX
    parity with `main.py:241-243`)."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        fname = f"events.out.tfevents.{int(time.time())}.layoutdm_tpu"
        self._f = open(os.path.join(logdir, fname), "ab")
        self._write(_encode_event(0, file_version="brain.Event:2"))

    def _write(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))

    def scalar(self, tag: str, value: float, step: int) -> None:
        self._write(_encode_event(step, summary=_scalar_summary(tag, value)))
        self._f.flush()

    def image(self, tag: str, pil_image, step: int) -> None:
        import io

        buf = io.BytesIO()
        pil_image.save(buf, format="PNG")
        w, h = pil_image.size
        self._write(
            _encode_event(
                step, summary=_image_summary(tag, buf.getvalue(), h, w)
            )
        )
        self._f.flush()

    def close(self) -> None:
        self._f.close()
