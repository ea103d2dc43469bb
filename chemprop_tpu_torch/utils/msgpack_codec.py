"""A small msgpack codec in pure Python, for the JAX package's checkpoints.

It writes and reads exactly what ``flax.serialization.to_bytes`` and
``msgpack_restore`` do, without the ``msgpack`` or ``flax`` packages: nested
maps with string keys, lists, ``None``, booleans, integers, floats (written as
float64), strings, bytes, and numpy arrays and scalars as flax's extension
types (1: an array, 2: a complex number, 3: a numpy scalar; an array's payload
is the msgpack of ``(shape, dtype name, C-order bytes)``). A bfloat16 array
(dtype name ``bfloat16``, which numpy lacks) decodes to a ``torch.bfloat16``
tensor, and a bfloat16 tensor encodes to one. flax's chunking of arrays over
2**30 bytes is not supported: such an array raises."""

from __future__ import annotations

import struct
from typing import Any

import numpy as np

_ND, _COMPLEX, _SCALAR = 1, 2, 3
_MAX_ARRAY_BYTES = 2**30


def _header(out: bytearray, n: int, small: int | None, small_max: int, codes: tuple) -> None:
    """A length header: the fix form below ``small_max``, else 8/16/32 bits."""
    if small is not None and n < small_max:
        out.append(small | n)
    elif codes[0] is not None and n <= 0xFF:
        out += bytes([codes[0], n])
    elif n <= 0xFFFF:
        out += bytes([codes[1]]) + struct.pack(">H", n)
    else:
        out += bytes([codes[2]]) + struct.pack(">I", n)


def _pack_int(out: bytearray, x: int) -> None:
    if -0x20 <= x < 0x80:
        out += struct.pack("b" if x < 0 else "B", x)
    elif 0 <= x <= 0xFF:
        out += b"\xcc" + struct.pack(">B", x)
    elif -0x80 <= x < 0:
        out += b"\xd0" + struct.pack(">b", x)
    elif 0 <= x <= 0xFFFF:
        out += b"\xcd" + struct.pack(">H", x)
    elif -0x8000 <= x < 0:
        out += b"\xd1" + struct.pack(">h", x)
    elif 0 <= x <= 0xFFFFFFFF:
        out += b"\xce" + struct.pack(">I", x)
    elif -0x80000000 <= x < 0:
        out += b"\xd2" + struct.pack(">i", x)
    elif 0 <= x <= 0xFFFFFFFFFFFFFFFF:
        out += b"\xcf" + struct.pack(">Q", x)
    elif -0x8000000000000000 <= x < 0:
        out += b"\xd3" + struct.pack(">q", x)
    else:
        raise OverflowError(f"integer {x} does not fit msgpack")


def _pack_ext(out: bytearray, code: int, data: bytes) -> None:
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(fixed[n])
    else:
        _header(out, n, None, 0, (0xC7, 0xC8, 0xC9))
    out += struct.pack("b", code) + data


def _array_payload(x) -> bytes:
    import torch

    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous()
        if x.dtype == torch.bfloat16:
            return packb((tuple(x.shape), "bfloat16", x.view(torch.int16).numpy().tobytes("C")))
        x = x.numpy()
    if x.dtype.hasobject:
        raise ValueError("object arrays cannot be written")
    if x.nbytes > _MAX_ARRAY_BYTES:
        raise ValueError(f"an array of {x.nbytes} bytes needs flax's chunking, not supported")
    return packb((x.shape, x.dtype.name, x.tobytes("C")))


def _pack(out: bytearray, x: Any) -> None:
    import torch

    if x is None:
        out.append(0xC0)
    elif x is True or x is False:
        out.append(0xC3 if x else 0xC2)
    elif isinstance(x, (np.ndarray, torch.Tensor)):
        _pack_ext(out, _ND, _array_payload(x))
    elif isinstance(x, np.generic):
        _pack_ext(out, _SCALAR, _array_payload(np.asarray(x)))
    elif isinstance(x, int):
        _pack_int(out, x)
    elif isinstance(x, float):
        out += b"\xcb" + struct.pack(">d", x)
    elif isinstance(x, complex):
        _pack_ext(out, _COMPLEX, packb((x.real, x.imag)))
    elif isinstance(x, str):
        data = x.encode("utf-8")
        _header(out, len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += data
    elif isinstance(x, (bytes, bytearray, memoryview)):
        data = bytes(x)
        _header(out, len(data), None, 0, (0xC4, 0xC5, 0xC6))
        out += data
    elif isinstance(x, (list, tuple)):
        _header(out, len(x), 0x90, 16, (None, 0xDC, 0xDD))
        for item in x:
            _pack(out, item)
    elif isinstance(x, dict):
        _header(out, len(x), 0x80, 16, (None, 0xDE, 0xDF))
        for k, v in x.items():
            _pack(out, k)
            _pack(out, v)
    else:
        raise TypeError(f"cannot write {type(x).__name__} as msgpack")


def packb(x: Any) -> bytes:
    """``x`` as msgpack bytes, the bytes ``flax.serialization`` writes."""
    out = bytearray()
    _pack(out, x)
    return bytes(out)


class _Reader:
    def __init__(self, data: bytes, raw: bool):
        self.data, self.pos, self.raw = memoryview(data), 0, raw

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        chunk = self.data[self.pos : self.pos + n].tobytes()
        self.pos += n
        return chunk

    def num(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def text(self, n: int):
        data = self.take(n)
        return data if self.raw else data.decode("utf-8")

    def ext(self, n: int):
        code = self.num("b")
        data = self.take(n)
        if code == _ND:
            return _array_from(data)
        if code == _SCALAR:
            return _array_from(data)[()]
        if code == _COMPLEX:
            re, im = unpackb(data)
            return complex(re, im)
        raise ValueError(f"unknown msgpack extension type {code}")

    def read(self) -> Any:
        b = self.num("B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.text(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                   0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.num(numbers[b])
        sizes = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H", 0xDB: ">I",
                 0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I", 0xC7: ">B", 0xC8: ">H",
                 0xC9: ">I"}
        if b in sizes:
            n = self.num(sizes[b])
            if b <= 0xC6:
                return self.take(n)
            if b <= 0xC9:
                return self.ext(n)
            if b <= 0xDB:
                return self.text(n)
            if b <= 0xDD:
                return [self.read() for _ in range(n)]
            return self.map(n)
        if 0xD4 <= b <= 0xD8:
            return self.ext(1 << (b - 0xD4))
        raise ValueError(f"invalid msgpack byte 0x{b:02x}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out


def _array_from(payload: bytes):
    shape, name, buf = _Reader(payload, raw=True).read()
    if name == b"bfloat16":
        import torch

        flat = np.frombuffer(buf, dtype=np.int16).copy()
        return torch.from_numpy(flat).view(torch.bfloat16).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(name.decode())).reshape(shape, order="C")


def unpackb(data: bytes) -> Any:
    """The tree msgpack ``data`` holds, as ``flax.serialization.msgpack_restore``
    gives it (arrays read-only, over the input's bytes)."""
    reader = _Reader(data, raw=False)
    out = reader.read()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after the msgpack object")
    return out
