"""TensorBoard event-file writer and reader, standard library only (a copy
of moldiff_tpu/utils/tb_writer.py).

TensorBoard's on-disk format is a TFRecord stream of serialized ``Event``
protos, simple enough to encode by hand:

  record   := len:uint64le  masked_crc32c(len):uint32le
              data:bytes    masked_crc32c(data):uint32le
  Event    := 1: wall_time (double)   2: step (int64)
              3: file_version (string, first record only: "brain.Event:2")
              5: summary (Summary)
  Summary  := 1: repeated Value { 1: tag (string), 2: simple_value (float) }

CRC is CRC-32C (Castagnoli), masked per the TFRecord spec:
``((crc >> 15) | (crc << 17)) + 0xa282ead8 (mod 2^32)``.

TensorBoard finds files named ``events.out.tfevents.<ts>.<host>``.
"""
from __future__ import annotations

import os
import socket
import struct
import time


# -- CRC-32C (Castagnoli, reflected, poly 0x82F63B78) ------------------------

def _make_table():
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_TABLE = _make_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# -- minimal protobuf encoding ------------------------------------------------

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


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _pb_double(field: int, v: float) -> bytes:
    return _tag(field, 1) + struct.pack("<d", v)


def _pb_float(field: int, v: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", v)


def _pb_int64(field: int, v: int) -> bytes:
    return _tag(field, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _pb_bytes(field: int, v: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(v)) + v


def _event(wall_time: float, step: int = 0, file_version: str = None,
           tag: str = None, value: float = None) -> bytes:
    msg = _pb_double(1, wall_time)
    if step:
        msg += _pb_int64(2, step)
    if file_version is not None:
        msg += _pb_bytes(3, file_version.encode())
    if tag is not None:
        val = _pb_bytes(1, tag.encode()) + _pb_float(2, float(value))
        msg += _pb_bytes(5, _pb_bytes(1, val))
    return msg


def _record(data: bytes) -> bytes:
    header = struct.pack("<Q", len(data))
    return (header + struct.pack("<I", _masked_crc(header))
            + data + struct.pack("<I", _masked_crc(data)))


class TBEventWriter:
    """Append-only scalar event writer TensorBoard can read directly."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        host = socket.gethostname().split(".")[0] or "host"
        self.path = os.path.join(
            logdir, f"events.out.tfevents.{int(time.time())}.{host}"
        )
        self._f = open(self.path, "ab")
        self._f.write(_record(_event(time.time(),
                                     file_version="brain.Event:2")))
        self._f.flush()

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._f.write(_record(_event(time.time(), step=int(step),
                                     tag=tag, value=float(value))))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self._f.flush()
            self._f.close()


# -- reader (for tests and offline inspection; TensorBoard itself is the
#    intended consumer) -------------------------------------------------------

def read_events(path: str) -> list:
    """Parse an event file back to [{'wall_time', 'step', 'tag', 'value',
    'file_version'}] dicts, verifying both CRCs of every record."""
    out = []
    with open(path, "rb") as f:
        data = f.read()
    off = 0
    while off < len(data):
        (n,) = struct.unpack_from("<Q", data, off)
        (hcrc,) = struct.unpack_from("<I", data, off + 8)
        assert hcrc == _masked_crc(data[off:off + 8]), "header crc mismatch"
        payload = data[off + 12:off + 12 + n]
        (dcrc,) = struct.unpack_from("<I", data, off + 12 + n)
        assert dcrc == _masked_crc(payload), "data crc mismatch"
        out.append(_parse_event(payload))
        off += 12 + n + 4
    return out


def _read_varint(buf: bytes, off: int):
    """A base-128 varint at ``off`` -> (value, next offset). The JAX
    package's reader never advances the shift, so it reads any value of
    128 or more (a step, a length) wrong; this one does."""
    n = shift = 0
    while True:
        b = buf[off]
        off += 1
        n |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return n, off


def _parse_fields(buf: bytes):
    off = 0
    while off < len(buf):
        key, off = _read_varint(buf, off)
        field, wire = key >> 3, key & 7
        if wire == 0:
            v, off = _read_varint(buf, off)
        elif wire == 1:
            v = struct.unpack_from("<d", buf, off)[0]
            off += 8
        elif wire == 5:
            v = struct.unpack_from("<f", buf, off)[0]
            off += 4
        elif wire == 2:
            n, off = _read_varint(buf, off)
            v = buf[off:off + n]
            off += n
        else:
            raise ValueError(f"wire type {wire}")
        yield field, wire, v


def _parse_event(buf: bytes) -> dict:
    ev = {"wall_time": None, "step": 0, "file_version": None,
          "tag": None, "value": None}
    for field, _, v in _parse_fields(buf):
        if field == 1:
            ev["wall_time"] = v
        elif field == 2:
            ev["step"] = v
        elif field == 3:
            ev["file_version"] = v.decode()
        elif field == 5:
            for f2, _, v2 in _parse_fields(v):
                if f2 == 1:  # Summary.Value
                    for f3, _, v3 in _parse_fields(v2):
                        if f3 == 1:
                            ev["tag"] = v3.decode()
                        elif f3 == 2:
                            ev["value"] = v3
    return ev
