"""Commit-payload compression for the PS wire (L1); the port's copy of
``distkeras_tpu/parallel/compression.py``, writing the same bytes.

The reference shipped every window's full weight delta as an
uncompressed pickle over TCP (SURVEY.md §3.2 hot-loop observation (b) —
"communication payload is the full weight set, uncompressed, per
window").  This module is the TPU-rebuild's answer for the DCN arm: a
delta codec quantizes (``int8``), sparsifies (``topk``), or narrows
(``bfloat16``) the commit payload before it hits the socket, and the
worker loop keeps the quantization *residual* locally, folding it into
the next window's delta (error feedback) so the lossy wire still
converges to the same optimum.

Codecs apply to the **delta family** of update rules (DOWNPOUR / ADAG /
DynSGD — ``payload_kind == 'delta'``): a delta is an additive update,
so an under-transmitted remainder can ride the next commit.  The
elastic family commits absolute parameters; lossy compression there
would not be error-correctable, and the trainer rejects it.

Wire format: msgpack list of per-leaf dicts (raw little-endian array
bytes + the codec's side data), ordered by the pytree flattening of the
parameter template both ends already share — no pickle, matching the
``parallel.transport`` policy.

The port encodes on the host with numpy, as the JAX package does (the
same ``np.argpartition`` top-k selection, so equal inputs give equal
bytes, ties included); the map goes through the port's own msgpack
packer (``serialization.packb``) and trees through ``parallel.trees``
(``jax.tree_util``'s order).  ``bfloat16`` rounds the f32 words to
nearest even on their ``uint32`` view, ``ml_dtypes``'s rule, NaN to
the quiet NaN of its sign.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from distkeras_tpu_torch import serialization
from distkeras_tpu_torch.parallel.trees import tree_leaves, tree_unflatten

Pytree = Any


class DeltaCodec:
    """Base codec: per-leaf encode/decode over the template's
    flattening order."""

    name: str = "identity"

    def encode_leaf(self, x: np.ndarray) -> dict:
        raise NotImplementedError

    def decode_leaf(self, enc: dict, shape, dtype) -> np.ndarray:
        raise NotImplementedError

    def encode_leaves(self, leaves) -> bytes:
        """Encode an ordered leaf LIST — the per-shard unit the
        sharded PS wire commits (``parallel.sharded_ps``); the
        full-tree ``encode`` is the K=1 special case."""
        return serialization.packb(
            [self.encode_leaf(np.asarray(x, np.float32))
             for x in leaves])

    def decode_leaves(self, data, template_leaves) -> list:
        """Inverse of ``encode_leaves`` against the shard's template
        leaves (shapes/dtypes)."""
        enc = serialization.unpackb(data)
        if len(enc) != len(template_leaves):
            raise ValueError(
                f"encoded payload has {len(enc)} leaves, template has "
                f"{len(template_leaves)}")
        return [self.decode_leaf(e, np.shape(t), np.asarray(t).dtype)
                for e, t in zip(enc, template_leaves)]

    def encode(self, tree: Pytree) -> bytes:
        return self.encode_leaves(tree_leaves(tree))

    def decode(self, data: bytes, template: Pytree) -> Pytree:
        return tree_unflatten(template,
                              self.decode_leaves(data, tree_leaves(template)))

    def round_trip(self, tree: Pytree) -> tuple[bytes, Pytree]:
        """``(wire bytes, the tree the receiver will reconstruct)`` —
        the reconstruction is what error feedback subtracts."""
        data = self.encode(tree)
        return data, self.decode(data, tree)

    def round_trip_shards(self, tree: Pytree, plan
                          ) -> tuple[list[bytes], Pytree]:
        """Per-shard ``round_trip``: encode each shard's leaf slice
        separately (``plan`` is ``sharded_ps.plan_shards`` output) so
        the worker loop encodes ONCE and hands the ready shard bodies
        to ``ShardedPSClient.commit``; the decoded reassembly is what
        error feedback subtracts — identical math to the full-tree
        ``round_trip`` (the codec is per-leaf)."""
        leaves = tree_leaves(tree)
        datas = [self.encode_leaves([leaves[i] for i in idx])
                 for idx in plan]
        out = [None] * len(leaves)
        for idx, data in zip(plan, datas):
            for i, leaf in zip(idx, self.decode_leaves(
                    data, [leaves[i] for i in idx])):
                out[i] = leaf
        return datas, tree_unflatten(tree, out)


class Int8Codec(DeltaCodec):
    """Per-leaf symmetric int8 quantization: ``scale = max|x| / 127``,
    ~4x smaller than f32 on the wire."""

    name = "int8"

    def encode_leaf(self, x):
        amax = float(np.max(np.abs(x))) if x.size else 0.0
        scale = amax / 127.0 if amax > 0 else 1.0
        q = np.clip(np.rint(x / scale), -127, 127).astype(np.int8)
        return {"s": scale, "q": q.tobytes()}

    def decode_leaf(self, enc, shape, dtype):
        q = np.frombuffer(enc["q"], np.int8).reshape(shape)
        return (q.astype(np.float32) * np.float32(enc["s"])).astype(
            dtype)


class TopKCodec(DeltaCodec):
    """Per-leaf magnitude top-k sparsification: transmit the largest
    ``fraction`` of entries (at least one) as (uint32 index, f32 value)
    pairs — ~``8 * fraction`` bytes per original 4-byte entry."""

    name = "topk"

    def __init__(self, fraction: float = 0.01):
        if not 0.0 < fraction <= 1.0:
            raise ValueError(
                f"fraction must be in (0, 1], got {fraction}")
        self.fraction = float(fraction)
        self.name = f"topk:{self.fraction}"

    def encode_leaf(self, x):
        flat = x.ravel()
        k = max(1, int(round(self.fraction * flat.size)))
        if k >= flat.size:
            idx = np.arange(flat.size, dtype=np.uint32)
        else:
            idx = np.argpartition(np.abs(flat),
                                  -k)[-k:].astype(np.uint32)
        return {"i": idx.tobytes(),
                "v": flat[idx].astype(np.float32).tobytes()}

    def decode_leaf(self, enc, shape, dtype):
        idx = np.frombuffer(enc["i"], np.uint32)
        vals = np.frombuffer(enc["v"], np.float32)
        out = np.zeros(int(np.prod(shape, dtype=np.int64)), np.float32)
        out[idx] = vals
        return out.reshape(shape).astype(dtype)


class Bf16Codec(DeltaCodec):
    """Cast values to bfloat16 on the wire — 2x smaller, mild loss,
    residual-corrected like the rest."""

    name = "bfloat16"

    def encode_leaf(self, x):
        return {"b": bf16_words(x).tobytes()}

    def decode_leaf(self, enc, shape, dtype):
        b = np.frombuffer(enc["b"], np.uint16).reshape(shape)
        return (b.astype(np.uint32) << 16).view(np.float32).astype(dtype)


def bf16_words(x: np.ndarray) -> np.ndarray:
    """The ``uint16`` words of ``x`` (f32) rounded to bfloat16: nearest,
    ties to even, on the ``uint32`` view; NaN becomes ``0x7FC0`` or
    ``0xFFC0`` by its sign (``ml_dtypes``' conversion)."""
    x = np.ascontiguousarray(x, np.float32)
    u = x.view(np.uint32)
    words = ((u + (((u >> 16) & 1) + np.uint32(0x7FFF))) >> 16).astype(
        np.uint16)
    nan = np.isnan(x)
    if nan.any():
        words[nan] = np.where(np.signbit(x[nan]), 0xFFC0, 0x7FC0)
    return words


def resolve_codec(spec) -> DeltaCodec | None:
    """``None`` | codec instance | name: ``'int8'``, ``'bfloat16'``
    (``'bf16'``), ``'topk'`` or ``'topk:<fraction>'``."""
    if spec is None or isinstance(spec, DeltaCodec):
        return spec
    if isinstance(spec, str):
        if spec == "int8":
            return Int8Codec()
        if spec in ("bf16", "bfloat16"):
            return Bf16Codec()
        if spec == "topk":
            return TopKCodec()
        if spec.startswith("topk:"):
            return TopKCodec(float(spec.split(":", 1)[1]))
        raise KeyError(
            f"unknown compression {spec!r}; known: 'int8', "
            f"'bfloat16', 'topk', 'topk:<fraction>'")
    raise TypeError(f"cannot resolve a codec from {type(spec)}")


def raw_nbytes(tree: Pytree) -> int:
    """Uncompressed wire size of a pytree (f32 leaf bytes) — the
    baseline the compression telemetry is measured against."""
    return sum(4 * int(np.size(x)) for x in tree_leaves(tree))
