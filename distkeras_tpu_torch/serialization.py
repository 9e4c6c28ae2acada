"""flax's msgpack format, written and read without flax or msgpack.

The JAX package's checkpoints, PS snapshots and serialized parameters
are ``flax.serialization`` bytes: msgpack of a "state dict" (nested
string-keyed dicts whose leaves are arrays and Python scalars).  The
port writes and reads the same bytes with this module, a pure-Python
packer and unpacker for the msgpack types flax emits:

* nil, bool, int, float (always float 64), str, bin, array and map,
  packed as ``msgpack.packb(..., use_bin_type=True, strict_types=True)``
  packs them: the smallest encoding of each, maps in insertion order;
* flax's ext types: 1, an ndarray, whose payload is the msgpack of
  ``(shape, dtype name, C-order bytes)``; 2, a complex number
  (``(real, imag)``); 3, a numpy scalar (an ndarray payload of shape
  ``()``);
* flax's chunked form for an array leaf of a dict larger than
  ``MAX_CHUNK_SIZE`` bytes: ``{"__msgpack_chunked_array__": True,
  "shape": {"0": ..}, "chunks": {"0": flat piece, ..}}``.

``to_bytes``/``msgpack_serialize``/``msgpack_restore`` follow flax's
functions of those names: ``to_state_dict`` turns lists and tuples into
``{"0": .., "1": ..}`` and named tuples into their fields;
``msgpack_serialize`` packs a tree with its dicts in key order (a tuple
raises, as under ``strict_types``); ``from_state_dict`` restores into a
template and, like flax, ignores keys the template lacks.

Leaves may be numpy arrays and scalars or torch tensors on any device.
Tensors on a card come to the host with one wait per call: each leaf
is copied into pinned host memory without waiting, and the host then
waits once, on an event recorded after the copies; nothing is gathered
on the card (``to_host``).  ``bfloat16`` leaves (which numpy cannot
hold without ``ml_dtypes``) are written from, and read back into,
torch: the payload is the 2-byte words, decoded as a ``torch.bfloat16``
tensor.  Every other dtype decodes to a read-only numpy array, as
flax's ``np.frombuffer`` gives.
"""

from __future__ import annotations

import struct
from typing import Any, Mapping

import numpy as np
import torch

#: leaves (in dicts) above this many bytes are written chunked;
#: flax's ``MAX_CHUNK_SIZE`` (2**30), read at every call
MAX_CHUNK_SIZE = 2 ** 30
_CHUNKED = "__msgpack_chunked_array__"
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


# -- host copies ---------------------------------------------------------


def _walk(tree, fn):
    if isinstance(tree, Mapping):
        return {k: _walk(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_walk(v, fn) for v in tree]
    if isinstance(tree, tuple) and not hasattr(tree, "_fields"):
        return tuple(_walk(v, fn) for v in tree)
    return fn(tree)


def to_host(tree):
    """``tree`` with every torch tensor replaced by a C-order host copy:
    numpy, or a CPU ``torch.bfloat16`` tensor.  A tensor on a card is
    laid out in C order there (a view is copied leaf by leaf, and each
    copy's memory serves the next: a save takes at most one leaf's
    memory on the card) and copied into pinned host memory without
    waiting; the host then waits once for each card, on an event
    recorded after the copies on the current stream, so a save waits
    once, not once per leaf, and a worker thread does not wait for
    other threads' later work."""
    devices: set[torch.device] = set()

    def copy(x):
        if not isinstance(x, torch.Tensor):
            return x
        x = x.detach()
        if x.device.type == "cpu":
            return x.clone(memory_format=torch.contiguous_format)
        devices.add(x.device)
        return x.contiguous().to("cpu", non_blocking=True)

    host = _walk(tree, copy)
    for device in devices:
        # wait for this thread's copies only: an event recorded after
        # them on the current stream (a device-wide synchronize would
        # also wait for work other threads queued on other streams)
        with torch.cuda.device(device):
            done = torch.cuda.Event()
            done.record()
        done.synchronize()
    return _walk(host, lambda x: x.numpy() if isinstance(x, torch.Tensor)
                 and x.dtype != torch.bfloat16 else x)


def device_get(tree):
    """``jax.device_get``'s host copy, as the JAX package's writers take
    it before packing: tensors to the host (``to_host``), numpy scalars
    to 0-d arrays."""
    return _walk(to_host(tree), lambda x: np.asarray(x)
                 if isinstance(x, np.generic) else x)


# -- state dicts -----------------------------------------------------------


def to_state_dict(target) -> Any:
    """flax's ``to_state_dict`` for dicts, lists, tuples and named
    tuples: dicts keep their order under string keys, sequences become
    ``{"0": .., "1": ..}``, named tuples ``{field: ..}``; leaves pass."""
    if isinstance(target, Mapping):
        keys = [str(k) for k in target]
        if len(set(keys)) != len(keys):
            raise ValueError(f"dict keys do not have a unique string "
                             f"representation: {list(target)}")
        return {str(k): to_state_dict(v) for k, v in target.items()}
    if isinstance(target, tuple) and hasattr(target, "_fields"):
        return {f: to_state_dict(getattr(target, f))
                for f in target._fields}
    if isinstance(target, (list, tuple)):
        return {str(i): to_state_dict(v) for i, v in enumerate(target)}
    return target


def from_state_dict(target, state) -> Any:
    """flax's ``from_state_dict``: the structure of ``target`` filled
    from ``state``.  A key of ``target`` missing from ``state`` raises;
    keys ``state`` has beyond ``target``'s are ignored; leaves are
    ``state``'s own."""
    if isinstance(target, Mapping):
        missing = {str(k) for k in target} - set(state)
        if missing:
            raise ValueError(
                f"The target dict keys and state dict keys do not match, "
                f"target dict contains keys {missing} which are not "
                f"present in state dict")
        return {k: from_state_dict(v, state[str(k)])
                for k, v in target.items()}
    if isinstance(target, (list, tuple)):
        if len(state) != len(target):
            raise ValueError(
                f"The size of the list and the state dict do not match, "
                f"got {len(target)} and {len(state)}")
        return type(target)(from_state_dict(v, state[str(i)])
                            for i, v in enumerate(target))
    return state


# -- chunking ---------------------------------------------------------------


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return x.size * x.dtype.itemsize


def _chunk(arr) -> dict:
    itemsize = arr.element_size() if isinstance(arr, torch.Tensor) \
        else arr.dtype.itemsize
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = arr.reshape(-1)
    n = flat.numel() if isinstance(flat, torch.Tensor) else flat.size
    return {_CHUNKED: True,
            "shape": {str(i): int(d) for i, d in enumerate(arr.shape)},
            "chunks": {str(j): flat[lo:lo + size]
                       for j, lo in enumerate(range(0, n, size))}}


def _is_array(x) -> bool:
    return isinstance(x, np.ndarray) or (
        isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16)


def _chunk_leaves(tree):
    """flax's ``_chunk_array_leaves_in_place``, on a copy: array leaves
    of dicts (and the tree itself) above ``MAX_CHUNK_SIZE`` bytes."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if _is_array(v):
                out[k] = _chunk(v) if _nbytes(v) > MAX_CHUNK_SIZE else v
            elif isinstance(v, dict):
                out[k] = _chunk_leaves(v)
            else:
                out[k] = v
        return out
    if _is_array(tree) and _nbytes(tree) > MAX_CHUNK_SIZE:
        return _chunk(tree)
    return tree


def _unchunk(data: dict):
    shape = tuple(data["shape"][str(i)] for i in range(len(data["shape"])))
    chunks = [data["chunks"][str(i)] for i in range(len(data["chunks"]))]
    if isinstance(chunks[0], torch.Tensor):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def _unchunk_leaves(tree):
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            return _unchunk(tree)
        for k, v in tree.items():
            if isinstance(v, dict):
                tree[k] = _unchunk_leaves(v)
    return tree


# -- packing ----------------------------------------------------------------


def _int(n: int) -> bytes:
    if 0 <= n < 0x80:
        return struct.pack("B", n)
    if -0x20 <= n < 0:
        return struct.pack("b", n)
    if 0x80 <= n <= 0xFF:
        return b"\xcc" + struct.pack("B", n)
    if -0x80 <= n < 0:
        return b"\xd0" + struct.pack("b", n)
    if 0xFF < n <= 0xFFFF:
        return b"\xcd" + struct.pack(">H", n)
    if -0x8000 <= n < -0x80:
        return b"\xd1" + struct.pack(">h", n)
    if 0xFFFF < n <= 0xFFFFFFFF:
        return b"\xce" + struct.pack(">I", n)
    if -0x80000000 <= n < -0x8000:
        return b"\xd2" + struct.pack(">i", n)
    if 0xFFFFFFFF < n <= 0xFFFFFFFFFFFFFFFF:
        return b"\xcf" + struct.pack(">Q", n)
    if -0x8000000000000000 <= n < -0x80000000:
        return b"\xd3" + struct.pack(">q", n)
    raise OverflowError("Integer value out of range")


def _sized(n: int, fix: tuple | None, codes: tuple) -> bytes:
    """Header of a str/bin/array/map of length ``n``: the fix form
    ``(base, limit)`` where it fits, else 8-, 16- or 32-bit lengths."""
    if fix is not None and n < fix[1]:
        return struct.pack("B", fix[0] | n)
    for code, fmt, limit in zip(codes, (">B", ">H", ">I"),
                                (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= limit:
            return code + struct.pack(fmt, n)
    raise ValueError(f"{n} is too large for msgpack")


def _str_header(n):
    return _sized(n, (0xA0, 32), (b"\xd9", b"\xda", b"\xdb"))


def _bin_header(n):
    return _sized(n, None, (b"\xc4", b"\xc5", b"\xc6"))


def _array_header(n):
    return _sized(n, (0x90, 16), (None, b"\xdc", b"\xdd"))


def _map_header(n):
    return _sized(n, (0x80, 16), (None, b"\xde", b"\xdf"))


_FIXEXT = {1: b"\xd4", 2: b"\xd5", 4: b"\xd6", 8: b"\xd7", 16: b"\xd8"}


def _ext(code: int, pieces: list) -> list:
    n = sum(len(p) for p in pieces)
    if n in _FIXEXT:
        head = _FIXEXT[n]
    else:
        head = _sized(n, None, (b"\xc7", b"\xc8", b"\xc9"))
    return [head + struct.pack("b", code), *pieces]


def _array_payload(x) -> list:
    """The msgpack of ``(shape, dtype name, C-order bytes)``, as pieces
    (the data a view, not a copy)."""
    if isinstance(x, torch.Tensor):               # bfloat16, on the host
        shape, name = tuple(x.shape), "bfloat16"
        data = memoryview(x.contiguous().view(torch.int16).numpy()) \
            .cast("B")
    else:
        if x.dtype.hasobject or x.dtype.isalignedstruct:
            raise ValueError("Object and structured dtypes not supported "
                             "for serialization of ndarrays.")
        shape, name = x.shape, x.dtype.name
        data = memoryview(np.ascontiguousarray(x).reshape(-1)
                          .view(np.uint8))
    head = [_array_header(3), _array_header(len(shape))]
    head += [_int(int(d)) for d in shape]
    encoded = name.encode()
    head += [_str_header(len(encoded)), encoded, _bin_header(len(data))]
    return [b"".join(head), data]


def _pack(obj, out: list) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif type(obj) is bool:
        out.append(b"\xc3" if obj else b"\xc2")
    elif type(obj) is int:
        out.append(_int(obj))
    elif type(obj) is float:
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif type(obj) in (bytes, bytearray, memoryview):
        data = memoryview(obj).cast("B")
        out += [_bin_header(len(data)), data]
    elif type(obj) is str:
        encoded = obj.encode()
        out += [_str_header(len(encoded)), encoded]
    elif type(obj) is list:
        out.append(_array_header(len(obj)))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, Mapping):
        out.append(_map_header(len(obj)))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, (np.ndarray, torch.Tensor)):  # after to_host
        out += _ext(_EXT_NDARRAY, _array_payload(obj))
    elif isinstance(obj, np.generic):
        out += _ext(_EXT_NPSCALAR, _array_payload(np.asarray(obj)))
    elif isinstance(obj, complex):
        out += _ext(_EXT_COMPLEX, [b"\x92", b"\xcb" + struct.pack(
            ">d", obj.real), b"\xcb" + struct.pack(">d", obj.imag)])
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def packb(obj) -> bytes:
    """``msgpack.packb(obj)``'s bytes (bin type on, maps in insertion
    order) for plain Python objects: None, bools, ints, floats, str,
    bytes, lists and dicts; no flax ext types beyond what ``_pack``
    writes for arrays."""
    out: list = []
    _pack(obj, out)
    return b"".join(out)


def unpackb(data) -> Any:
    """``msgpack.unpackb(data)``: bins as ``bytes``, strs as ``str``."""
    reader = _Reader(data)
    obj = reader.read()
    if reader.pos != len(reader.buf):
        raise ValueError("extra data after the msgpack object")
    return obj


def pack_pieces(tree) -> list:
    """``msgpack_serialize(tree)`` as a list of byte pieces (views of
    the leaves' data), for writing to a file without joining."""
    out: list = []
    _pack(_chunk_leaves(to_host(tree)), out)
    return out


def sort_keys(tree):
    """``tree`` with every dict's keys in sorted order, as any JAX tree
    transformation leaves them (``jax.tree_util`` flattens dicts in key
    order)."""
    if isinstance(tree, Mapping):
        return {k: sort_keys(tree[k]) for k in sorted(tree)}
    if isinstance(tree, list):
        return [sort_keys(v) for v in tree]
    return tree


def msgpack_serialize(tree) -> bytes:
    """flax's ``msgpack_serialize``: the tree (dicts, lists, scalars,
    array leaves) with its dicts in key order (flax copies it with
    ``jax.tree_util.tree_map`` first), oversized dict leaves chunked."""
    return b"".join(pack_pieces(sort_keys(tree)))


def to_bytes(target) -> bytes:
    """flax's ``to_bytes``: ``to_state_dict(target)`` packed in its own
    order (flax serializes it in place)."""
    return b"".join(pack_pieces(to_state_dict(target)))


# -- unpacking --------------------------------------------------------------


def _ndarray(data: memoryview):
    shape, name, buf = _Reader(data, raw=True).read()
    name = name.decode()
    if name == "bfloat16":
        words = np.frombuffer(buf, dtype=np.int16)
        return torch.from_numpy(words.copy()).view(torch.bfloat16) \
            .reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape)


class _Reader:
    """A msgpack decoder over one buffer: ``raw`` leaves str as bytes
    (flax's ndarray payloads are read so); bins are views of the
    buffer."""

    def __init__(self, data, raw: bool = False):
        self.buf = memoryview(data).cast("B")
        self.pos = 0
        self.raw = raw

    def take(self, n: int) -> memoryview:
        start = self.pos
        self.pos += n
        if self.pos > len(self.buf):
            raise ValueError("truncated msgpack data")
        return self.buf[start:self.pos]

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def text(self, n: int):
        data = self.take(n)
        return bytes(data) if self.raw else str(data, "utf-8")

    def ext(self, n: int):
        code = self.unpack("b")
        data = self.take(n)
        if code == _EXT_NDARRAY:
            return _ndarray(data)
        if code == _EXT_NPSCALAR:
            return _ndarray(data)[()]
        if code == _EXT_COMPLEX:
            real, imag = _Reader(data).read()
            return complex(real, imag)
        raise ValueError(f"unknown msgpack ext type {code}")

    def read(self):
        b = self.unpack("B")
        if b < 0x80:
            return b
        if b >= 0xE0:
            return b - 0x100
        if b < 0x90:
            return self.map(b & 0x0F)
        if b < 0xA0:
            return [self.read() for _ in range(b & 0x0F)]
        if b < 0xC0:
            return self.text(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        fixed = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H",
                 0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
                 0xD2: ">i", 0xD3: ">q"}
        if b in fixed:
            return self.unpack(fixed[b])
        sizes = {0: ">B", 1: ">H", 2: ">I"}
        if 0xC4 <= b <= 0xC6:
            data = self.take(self.unpack(sizes[b - 0xC4]))
            return data if self.raw else bytes(data)
        if 0xC7 <= b <= 0xC9:
            return self.ext(self.unpack(sizes[b - 0xC7]))
        if 0xD4 <= b <= 0xD8:
            return self.ext(1 << (b - 0xD4))
        if 0xD9 <= b <= 0xDB:
            return self.text(self.unpack(sizes[b - 0xD9]))
        if b in (0xDC, 0xDD):
            n = self.unpack(sizes[b - 0xDB])
            return [self.read() for _ in range(n)]
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(sizes[b - 0xDD]))
        raise ValueError(f"unknown msgpack type byte 0x{b:02x}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out


def msgpack_restore(data) -> Any:
    """flax's ``msgpack_restore``: the tree of ``data``, chunked leaves
    joined again."""
    reader = _Reader(data)
    tree = reader.read()
    if reader.pos != len(reader.buf):
        raise ValueError("extra data after the msgpack object")
    return _unchunk_leaves(tree)

