"""Dependency-free TensorBoard scalar writer.

A copy of ``recommender_tpu/core/tensorboard.py`` (importing the original
runs its package's ``__init__``, which imports jax); a test holds the bytes
it writes against the original's for the same calls and clock.

The reference logs training curves through the Keras TensorBoard callback
(`ctr/train.py:94`). This module reproduces that observability surface
without importing TF or the tensorboard package (neither exists in this
environment): it hand-encodes the two tiny protobuf messages TensorBoard's
scalar dashboard needs (``Event`` wrapping ``Summary{Value{tag,
simple_value}}``) and frames them in the TFRecord event-file format
(length ∥ masked-CRC32C(length) ∥ payload ∥ masked-CRC32C(payload)), so the
output files open in stock TensorBoard / tensorboard.dev.

Scalars only — that is all the reference ever wrote (loss/AUC curves).
"""
from __future__ import annotations

import math
import os
import socket
import struct
import time

# ---------------------------------------------------------------- CRC32C
# Castagnoli CRC (poly 0x82F63B78, reflected), table-driven. Verified in
# tests against the standard vector crc32c(b"123456789") == 0xE3069283.
_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ (0x82F63B78 * (_c & 1))
    _TABLE.append(_c)


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ _TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ------------------------------------------------------- proto wire format
def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _len_field(field_no: int, payload: bytes) -> bytes:
    return _varint((field_no << 3) | 2) + _varint(len(payload)) + payload


def _scalar_value(tag: str, value: float) -> bytes:
    """summary.proto ``Value``: tag=1 (string), simple_value=2 (float)."""
    return _len_field(1, tag.encode()) + struct.pack("<Bf", (2 << 3) | 5, value)


def _event(wall_time: float, step: int, *, summary: bytes = b"",
           file_version: str = "") -> bytes:
    """event.proto ``Event``: wall_time=1 (double), step=2 (int64),
    file_version=3 (string) / summary=5 (message)."""
    out = struct.pack("<Bd", (1 << 3) | 1, wall_time)
    out += _varint((2 << 3) | 0) + _varint(step & 0xFFFFFFFFFFFFFFFF)
    if file_version:
        out += _len_field(3, file_version.encode())
    if summary:
        out += _len_field(5, summary)
    return out


def _record(payload: bytes) -> bytes:
    header = struct.pack("<Q", len(payload))
    return (header + struct.pack("<I", _masked_crc(header)) + payload
            + struct.pack("<I", _masked_crc(payload)))


class SummaryWriter:
    """Append-only scalar event file, stock-TensorBoard-readable.

    >>> w = SummaryWriter("runs/run1")
    >>> w.scalar("train/loss", 0.69, step=100)
    >>> w.close()
    """

    _seq = 0  # per-process uniquifier (with the pid, prevents two writers
    # ever appending to one file and interleaving records)

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        SummaryWriter._seq += 1
        name = "events.out.tfevents.%d.%s.%d.%d" % (
            int(time.time()), socket.gethostname(), os.getpid(),
            SummaryWriter._seq)
        self.path = os.path.join(log_dir, name)
        self._f = open(self.path, "ab")
        self._f.write(_record(_event(time.time(), 0, file_version="brain.Event:2")))

    def scalar(self, tag: str, value: float, step: int) -> None:
        summary = _len_field(1, _scalar_value(tag, float(value)))
        self._f.write(_record(_event(time.time(), int(step), summary=summary)))

    def scalars(self, metrics: dict, step: int, prefix: str = "") -> None:
        """Write every finite-numeric entry of ``metrics`` (skips 'step')."""
        for k, v in metrics.items():
            if (k == "step" or isinstance(v, bool)
                    or not isinstance(v, (int, float))
                    or not math.isfinite(v)):
                continue
            self.scalar(prefix + k, v, step)

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.flush()
        self._f.close()


def read_scalars(path: str):
    """Decode an event file back to ``[(step, tag, value), ...]``.

    Used by tests (round-trip) and as a no-deps way to inspect run curves;
    validates both CRCs of every record.
    """
    out = []
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    while pos < len(data):
        (n,) = struct.unpack_from("<Q", data, pos)
        header = data[pos:pos + 8]
        (hcrc,) = struct.unpack_from("<I", data, pos + 8)
        payload = data[pos + 12:pos + 12 + n]
        (pcrc,) = struct.unpack_from("<I", data, pos + 12 + n)
        if hcrc != _masked_crc(header) or pcrc != _masked_crc(payload):
            raise ValueError(f"corrupt event record at byte {pos}")
        pos += 12 + n + 4
        out.extend(_decode_event(payload))
    return out


def _decode_fields(buf: bytes):
    """Yield (field_no, wire_type, value) from a proto buffer."""
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
        elif wire == 1:
            (val,) = struct.unpack_from("<d", buf, pos)
            pos += 8
        elif wire == 5:
            (val,) = struct.unpack_from("<f", buf, pos)
            pos += 4
        elif wire == 2:
            n, pos = _read_varint(buf, pos)
            val = buf[pos:pos + n]
            pos += n
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _read_varint(buf: bytes, pos: int):
    n = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, pos
        shift += 7


def _decode_event(payload: bytes):
    step, summary = 0, None
    for field, _, val in _decode_fields(payload):
        if field == 2:
            step = val
        elif field == 5:
            summary = val
    if summary is None:
        return []
    out = []
    for field, _, val in _decode_fields(summary):
        if field != 1:
            continue
        tag, value = "", None
        for f2, w2, v2 in _decode_fields(val):
            if f2 == 1:
                tag = v2.decode()
            elif f2 == 2 and w2 == 5:
                value = v2
        if value is not None:
            out.append((step, tag, value))
    return out
