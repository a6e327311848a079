"""The subset of MessagePack that a checkpoint payload uses.

``packb`` writes maps, strings, byte strings, arrays and integers (plus
nil and booleans) with the encoding ``msgpack.packb(obj,
use_bin_type=True)`` picks: the smallest of fixstr/str8/str16/str32,
bin8/bin16/bin32, fixarray/array16/array32, fixmap/map16/map32 and
fixint/uint8-64 (int8-64 below zero), big-endian lengths, dict entries in
insertion order.  So the same payload gives the same bytes as the
reference's.  ``unpackb`` reads those types back (``raw=False``: strings
as ``str``); byte strings come back as ``memoryview`` slices of the input,
with no copy.  Floats and extension types are not part of a checkpoint and
raise.

A byte string may also be given as ``Reserved(nbytes, fill)``: ``packb``
then writes it straight into the packed buffer (``fill`` gets a writable
view of its ``nbytes`` bytes), so a large payload, a tensor on a GPU for
one, is copied once, and the result is a ``bytearray``.
"""
from __future__ import annotations

import struct

_BUFFERS = (bytes, bytearray, memoryview)


class Reserved:
    """``nbytes`` bytes of a byte string that ``fill(view)`` writes into
    the packed buffer itself."""
    __slots__ = ("nbytes", "fill")

    def __init__(self, nbytes: int, fill):
        self.nbytes, self.fill = nbytes, fill


def _header(n, small_tag, small_max, tags):
    """The header of a container or string of length ``n``: the fix form
    ``small_tag | n`` up to ``small_max``, else the first of ``tags``
    ((tag, struct format, max)) whose max holds ``n``."""
    if small_tag is not None and n <= small_max:
        return bytes((small_tag | n,))
    for tag, fmt, top in tags:
        if n <= top:
            return bytes((tag,)) + struct.pack(fmt, n)
    raise ValueError(f"length {n} does not fit MessagePack")


_STR = ((0xd9, ">B", 0xff), (0xda, ">H", 0xffff), (0xdb, ">I", 0xffffffff))
_BIN = ((0xc4, ">B", 0xff), (0xc5, ">H", 0xffff), (0xc6, ">I", 0xffffffff))
_ARRAY = ((0xdc, ">H", 0xffff), (0xdd, ">I", 0xffffffff))
_MAP = ((0xde, ">H", 0xffff), (0xdf, ">I", 0xffffffff))


def _int(v: int) -> bytes:
    if 0 <= v <= 0x7f:
        return bytes((v,))
    if v > 0:
        for tag, fmt, top in ((0xcc, ">B", 0xff), (0xcd, ">H", 0xffff),
                              (0xce, ">I", 0xffffffff),
                              (0xcf, ">Q", 0xffffffffffffffff)):
            if v <= top:
                return bytes((tag,)) + struct.pack(fmt, v)
        raise OverflowError(f"int {v} does not fit MessagePack")
    if v >= -32:
        return struct.pack(">b", v)
    for tag, fmt, bottom in ((0xd0, ">b", -2 ** 7), (0xd1, ">h", -2 ** 15),
                             (0xd2, ">i", -2 ** 31), (0xd3, ">q", -2 ** 63)):
        if v >= bottom:
            return bytes((tag,)) + struct.pack(fmt, v)
    raise OverflowError(f"int {v} does not fit MessagePack")


def _pack(obj, out: list) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        out.append(_int(int(obj)))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        out.append(_header(len(data), 0xa0, 31, _STR))
        out.append(data)
    elif isinstance(obj, _BUFFERS):
        view = memoryview(obj).cast("B")
        out.append(_header(len(view), None, -1, _BIN))
        out.append(view)
    elif isinstance(obj, Reserved):
        out.append(_header(obj.nbytes, None, -1, _BIN))
        out.append(obj)
    elif isinstance(obj, dict):
        out.append(_header(len(obj), 0x80, 15, _MAP))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, (list, tuple)):
        out.append(_header(len(obj), 0x90, 15, _ARRAY))
        for v in obj:
            _pack(v, out)
    else:
        raise TypeError(f"cannot pack {type(obj).__name__} into a "
                        "checkpoint payload")


def packb(obj):
    """``obj`` as MessagePack bytes (``msgpack.packb(obj,
    use_bin_type=True)`` for the types above); a ``bytearray`` where
    ``obj`` holds a ``Reserved`` byte string."""
    out: list = []
    _pack(obj, out)
    if not any(isinstance(c, Reserved) for c in out):
        return b"".join(out)
    buf = bytearray(sum(c.nbytes if isinstance(c, Reserved) else len(c)
                        for c in out))
    view, pos = memoryview(buf), 0
    for c in out:
        if isinstance(c, Reserved):
            if c.nbytes:
                c.fill(view[pos:pos + c.nbytes])
            pos += c.nbytes
        else:
            view[pos:pos + len(c)] = c
            pos += len(c)
    return buf


class _Reader:
    def __init__(self, data):
        self.buf = memoryview(data).cast("B")
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError("truncated MessagePack data")
        view = self.buf[self.pos:end]
        self.pos = end
        return view

    def num(self, fmt: str) -> int:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def str(self, n: int) -> str:
        return str(self.take(n), "utf-8")

    def array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out

    def read(self):
        tag = self.num(">B")
        if tag <= 0x7f:
            return tag
        if tag >= 0xe0:
            return tag - 0x100
        if 0x80 <= tag <= 0x8f:
            return self.map(tag & 0x0f)
        if 0x90 <= tag <= 0x9f:
            return self.array(tag & 0x0f)
        if 0xa0 <= tag <= 0xbf:
            return self.str(tag & 0x1f)
        if tag == 0xc0:
            return None
        if tag in (0xc2, 0xc3):
            return tag == 0xc3
        ints = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q",
                0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
        if tag in ints:
            return self.num(ints[tag])
        sizes = {0: ">B", 1: ">H", 2: ">I"}
        if 0xc4 <= tag <= 0xc6:
            return self.take(self.num(sizes[tag - 0xc4]))
        if 0xd9 <= tag <= 0xdb:
            return self.str(self.num(sizes[tag - 0xd9]))
        if tag in (0xdc, 0xdd):
            return self.array(self.num(sizes[tag - 0xdc + 1]))
        if tag in (0xde, 0xdf):
            return self.map(self.num(sizes[tag - 0xde + 1]))
        raise ValueError(f"MessagePack type 0x{tag:02x} is not part of a "
                         "checkpoint payload")


def unpackb(data):
    """The object packed in ``data`` (one object, nothing after it)."""
    reader = _Reader(data)
    obj = reader.read()
    if reader.pos != len(reader.buf):
        raise ValueError(f"{len(reader.buf) - reader.pos} bytes after the "
                         "MessagePack object")
    return obj
