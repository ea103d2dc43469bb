"""TensorBoard scalar events without the tensorboard package (cf.
``chemprop_tpu/utils/tbevents.py``, whose bytes this writer repeats): a
tfevents file is TFRecord framing (a little-endian length, its masked
CRC32C, the payload, the payload's masked CRC32C) around hand-encoded
``Event`` protobuf messages, the first holding ``file_version``
(``brain.Event:2``), each later one a ``Summary`` of one ``simple_value``.
``Trainer(tensorboard_dir=...)`` writes one ``add_scalars`` per epoch
record."""

from __future__ import annotations

import os
import socket
import struct
import time
from pathlib import Path

# ----------------------------------------------------------------- CRC32C
_CRC_TABLE: list[int] = []


def _build_table() -> None:
    poly = 0x82F63B78  # Castagnoli, reflected
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        _CRC_TABLE.append(c)


_build_table()


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ----------------------------------------------------------- protobuf bits
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


def _field_len(num: int, payload: bytes) -> bytes:
    return _varint((num << 3) | 2) + _varint(len(payload)) + payload


def _event(wall_time: float, step: int, body: bytes = b"") -> bytes:
    # Event: 1=wall_time(double) 2=step(int64) (+ caller-encoded fields)
    msg = struct.pack("<BdB", 0x09, wall_time, 0x10) + _varint(step) + body
    return msg


def _scalar_summary(tag: str, value: float) -> bytes:
    # Summary.Value: 1=tag(string) 2=simple_value(float)
    v = _field_len(1, tag.encode()) + struct.pack("<Bf", 0x15, value)
    # Summary: repeated 1=value; Event: 5=summary
    return _field_len(5, _field_len(1, v))


class ScalarEventWriter:
    """Append-only tfevents scalar writer (``add_scalar``/``flush``/``close``)."""

    def __init__(self, log_dir: str | Path):
        log_dir = Path(log_dir)
        log_dir.mkdir(parents=True, exist_ok=True)
        fname = (
            f"events.out.tfevents.{int(time.time())}."
            f"{socket.gethostname()}.{os.getpid()}.0"
        )
        self.path = log_dir / fname
        self._f = open(self.path, "ab")
        # header record: file_version (Event field 3)
        self._write(_event(time.time(), 0, _field_len(3, b"brain.Event:2")))

    def _write(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._write(_event(time.time(), int(step), _scalar_summary(tag, float(value))))

    def add_scalars(self, record: dict, step: int, skip: tuple[str, ...] = ("epoch",)) -> None:
        for k, v in record.items():
            if k in skip or not isinstance(v, (int, float)):
                continue
            self.add_scalar(k, float(v), step)

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self._f.flush()
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
