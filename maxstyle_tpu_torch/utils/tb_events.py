"""Dependency-free TensorBoard event-file writer.

The port's own copy of ``maxstyle_tpu/utils/tb_events.py``: the same
records, byte for byte, for the same wall time.

The reference's observability contract is TensorBoard scalars
(train_adv_supervised_segmentation_triplet.py:130-131,538-541; README.md
documents `tensorboard --logdir ./saved`). This module writes the TFRecord/
Event wire format directly — ~100 lines of protobuf/CRC encoding — so
`--log` produces real `events.out.tfevents.*` files without importing
TensorFlow (torch's SummaryWriter transitively imports all of TF, ~15 s and
hundreds of MB).

Wire format:
  record   := uint64le(len) crc32c_masked(len bytes) payload crc32c_masked(payload)
  payload  := Event proto
  Event    := { double wall_time = 1; int64 step = 2;
                oneof { string file_version = 3; Summary summary = 5; } }
  Summary  := { repeated Value value = 1 }
  Value    := { string tag = 1; float simple_value = 2 }
The first record of a file is Event{wall_time, file_version="brain.Event:2"}.
"""

from __future__ import annotations

import os
import socket
import struct
import time


def _crc32c_table():
    poly = 0x82F63B78
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        table.append(c)
    return table


_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        bits = n & 0x7F
        n >>= 7
        if n:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _len_delim(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


def _summary_value(tag_name: str, value: float) -> bytes:
    v = (_len_delim(1, tag_name.encode("utf-8"))
         + _tag(2, 5) + struct.pack("<f", value))
    return _len_delim(1, v)  # Summary.value (repeated field 1)


def encode_event(wall_time: float, step: int | None = None,
                 file_version: str | None = None,
                 scalars: dict | None = None) -> bytes:
    ev = _tag(1, 1) + struct.pack("<d", wall_time)
    if step is not None:
        ev += _tag(2, 0) + _varint(step & 0xFFFFFFFFFFFFFFFF)
    if file_version is not None:
        ev += _len_delim(3, file_version.encode("utf-8"))
    if scalars:
        summary = b"".join(_summary_value(k, float(v))
                           for k, v in scalars.items())
        ev += _len_delim(5, summary)
    return ev


def encode_record(payload: bytes) -> bytes:
    header = struct.pack("<Q", len(payload))
    return (header + struct.pack("<I", masked_crc32c(header))
            + payload + struct.pack("<I", masked_crc32c(payload)))


class EventFileWriter:
    """Append-only TB scalar writer for one run directory."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        name = (f"events.out.tfevents.{int(time.time())}."
                f"{socket.gethostname()}.{os.getpid()}.maxstyle")
        self.path = os.path.join(log_dir, name)
        self._f = open(self.path, "ab")
        self._write(encode_event(time.time(), file_version="brain.Event:2"))

    def _write(self, payload: bytes):
        self._f.write(encode_record(payload))

    def add_scalars(self, scalars: dict, step: int):
        """Write one Event carrying all channels at this step."""
        self._write(encode_event(time.time(), step=step, scalars=scalars))
        self._f.flush()

    def add_scalar(self, tag: str, value: float, step: int):
        self.add_scalars({tag: value}, step)

    def close(self):
        self._f.close()


# ---------------------------------------------------------------------------
# reader (for tests and offline inspection — not used by the trainer)
# ---------------------------------------------------------------------------


def read_events(path: str):
    """Parse an event file -> list of {wall_time, step, scalars} dicts."""
    out = []
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    while pos < len(data):
        (n,) = struct.unpack_from("<Q", data, pos)
        (len_crc,) = struct.unpack_from("<I", data, pos + 8)
        header = data[pos:pos + 8]
        if masked_crc32c(header) != len_crc:
            raise ValueError("corrupt length crc")
        payload = data[pos + 12:pos + 12 + n]
        (crc,) = struct.unpack_from("<I", data, pos + 12 + n)
        if masked_crc32c(payload) != crc:
            raise ValueError("corrupt payload crc")
        out.append(_decode_event(payload))
        pos += 12 + n + 4
    return out


def _read_varint(buf, pos):
    shift, val = 0, 0
    while True:
        b = buf[pos]
        val |= (b & 0x7F) << shift
        pos += 1
        if not b & 0x80:
            return val, pos
        shift += 7


def _decode_fields(buf):
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
        elif wire == 1:
            val = buf[pos:pos + 8]
            pos += 8
        elif wire == 2:
            n, pos = _read_varint(buf, pos)
            val = buf[pos:pos + n]
            pos += n
        elif wire == 5:
            val = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"wire type {wire}")
        yield field, wire, val


def _decode_event(payload):
    ev = {"wall_time": None, "step": 0, "scalars": {}, "file_version": None}
    for field, wire, val in _decode_fields(payload):
        if field == 1 and wire == 1:
            ev["wall_time"] = struct.unpack("<d", val)[0]
        elif field == 2:
            ev["step"] = val
        elif field == 3:
            ev["file_version"] = val.decode("utf-8")
        elif field == 5:
            for f2, w2, v2 in _decode_fields(val):
                if f2 == 1 and w2 == 2:
                    tag, value = None, None
                    for f3, w3, v3 in _decode_fields(v2):
                        if f3 == 1:
                            tag = v3.decode("utf-8")
                        elif f3 == 2 and w3 == 5:
                            value = struct.unpack("<f", v3)[0]
                    if tag is not None:
                        ev["scalars"][tag] = value
    return ev
