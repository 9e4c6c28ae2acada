"""Ring attention: exact attention over a sequence split into the blocks
of a ring of ranks; the port of ``distkeras_tpu/parallel/ring_attention.py``.

Rank ``r`` of an ``n``-rank ring holds global positions ``[r * T_local,
(r + 1) * T_local)``.  Its query block stays put while the key/value
blocks travel the ring, one hop per step (rank ``r`` sends to ``r - 1``
and receives from ``r + 1``, the JAX ring's permutation), so at step
``s`` rank ``r`` sees block ``(r + s) % n`` and folds it into its
online-softmax state.  The backward is the flash backward run as a
reverse ring: it saves only ``(q, k, v, out, lse)``, dq accumulates at
home in f32, and the f32 dk/dv accumulators travel WITH their k/v block
and arrive home after ``n`` hops.  Every hop is launched, a wholly
future (dead) one too, so the launches per call are fixed: ``n`` hops
per rank and direction.

``impl="xla"`` composes each hop's online softmax from PyTorch products
(the JAX package's ``_forward_scan``/``_bwd``, with ``q_chunk``);
``impl="flash"`` runs each hop through the hop kernels of
``ops.attention`` (kernels #3-#4 on CUDA tensors, their plain versions
on CPU tensors).

A ring comes in two forms, with one hop order and one accumulator carry:

* ``ProcessGroupRing``: one rank per process of a ``torch.distributed``
  group (NCCL across cards, gloo on the CPU); each hop is one
  ``batch_isend_irecv``.
* ``InProcessRing(n)``: all ``n`` ranks in this process, run in turn on
  one device.  It takes the whole sequence, splits it into ``n`` blocks
  and carries out the same hops, the counterpart of the virtual mesh on
  which the JAX package's tests run its ring.

Models name the ring by a string (``TransformerLM(seq_axis="seq")``, as
the JAX package names a mesh axis); ``sequence_sharded_apply`` binds
that name to a ring while a function runs.  ``axis_name=None`` is the
ring of one rank: device-local blockwise attention.
"""

from __future__ import annotations

import contextlib
import functools
import threading

import torch
from torch.autograd.function import once_differentiable

from distkeras_tpu_torch.ops import attention as _attention

_NEG = -1e30
_IMPLS = ("xla", "flash")


class InProcessRing:
    """A ring of ``n`` ranks that all live in this process: the caller
    passes the whole sequence and the ranks' hops run in turn."""

    def __init__(self, n: int):
        if n < 1:
            raise ValueError(f"a ring needs at least one rank; got {n}")
        self.size = int(n)
        self.ranks = tuple(range(self.size))

    def shift(self, *streams):
        """Each stream (a list, one tensor per rank) moved one hop:
        rank ``r`` now holds what rank ``r + 1`` held."""
        return [s[1:] + s[:1] for s in streams]


class ProcessGroupRing:
    """One rank per process of a ``torch.distributed`` group (default:
    the world).  Rank ``r`` passes the sequence's block ``r``."""

    def __init__(self, group=None):
        import torch.distributed as dist

        self.group = group
        self.size = dist.get_world_size(group)
        me = dist.get_rank(group)
        self.ranks = (me,)
        self._prev = self._global((me - 1) % self.size)
        self._next = self._global((me + 1) % self.size)

    def _global(self, rank: int) -> int:
        import torch.distributed as dist

        return rank if self.group is None else dist.get_global_rank(
            self.group, rank)

    def shift(self, *streams):
        """Send each stream's tensor to rank ``r - 1`` and receive rank
        ``r + 1``'s, all in one ``batch_isend_irecv``."""
        import torch.distributed as dist

        if self.size == 1:
            return [list(s) for s in streams]
        ops, out = [], []
        for tag, (x,) in enumerate(streams):
            x = x.contiguous()
            buf = torch.empty_like(x)
            ops += [dist.P2POp(dist.isend, x, self._prev, self.group, tag),
                    dist.P2POp(dist.irecv, buf, self._next, self.group, tag)]
            out.append([buf])
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return out


_LOCAL = InProcessRing(1)
# name -> ring, per thread: a binding lives while its
# sequence_sharded_apply call runs on that thread (the backward needs
# none: the ring rides in the autograd context)
_BOUND = threading.local()


def _bound() -> dict:
    if not hasattr(_BOUND, "rings"):
        _BOUND.rings = {}
    return _BOUND.rings


@contextlib.contextmanager
def _bind(name: str, ring):
    rings = _bound()
    before = rings.get(name)
    rings[name] = ring
    try:
        yield ring
    finally:
        if before is None:
            del rings[name]
        else:
            rings[name] = before


def resolve_ring(axis_name):
    """The ring ``axis_name`` names: None is the one-rank ring, a string
    the ring bound to it by ``sequence_sharded_apply``, a ring itself."""
    if axis_name is None:
        return _LOCAL
    if isinstance(axis_name, str):
        rings = _bound()
        if axis_name not in rings:
            raise ValueError(
                f"no ring is bound to the axis {axis_name!r}: run the "
                f"call under sequence_sharded_apply(fn, ring, "
                f"{axis_name!r})")
        return rings[axis_name]
    return axis_name


def _chunks(q_chunk, t_local):
    """Validated (n_chunks, chunk_len) for within-block q chunking."""
    if q_chunk is None or q_chunk >= t_local:
        return 1, t_local
    if q_chunk < 1 or t_local % q_chunk:
        raise ValueError(
            f"q_chunk={q_chunk} must be a positive divisor of the "
            f"local sequence length {t_local}")
    return t_local // q_chunk, q_chunk


def _blocks(x, nl: int):
    """``[B, T, H, D]`` -> ``[nl, B, H, T/nl, D]``, contiguous: one
    ``[B, H, T_local, D]`` block per rank held here."""
    b, t, h, d = x.shape
    return x.reshape(b, nl, t // nl, h, d).permute(1, 0, 3, 2, 4).contiguous()


def _unblock(x):
    """``[nl, B, H, T_local, D]`` -> ``[B, T, H, D]``."""
    nl, b, h, tl, d = x.shape
    return x.permute(1, 0, 3, 2, 4).reshape(b, nl * tl, h, d)


# ---- one hop, composed from PyTorch products (impl="xla") ----------


def _xla_hop_fwd(q, k, v, m, l, acc, *, q_offset, k_offset, scale, causal,
                 q_chunk):
    """The JAX ``_forward_scan`` body on ``[B, H, T, D]`` blocks: f32
    throughout, exact zeros for masked entries, q in chunks."""
    k32, v32 = k.float(), v.float()
    n_c, qc = _chunks(q_chunk, q.shape[2])
    parts = []
    for c in range(n_c):
        rows = slice(c * qc, (c + 1) * qc)
        logits = torch.matmul(q[:, :, rows].float(),
                              k32.transpose(-1, -2)) * scale
        if causal:
            keep = _attention._hop_keep(qc, k.shape[2], q_offset + c * qc,
                                        k_offset, q.device)
            logits = logits.masked_fill(~keep, _NEG)
        m_c = m[:, :, rows]
        m_new = torch.maximum(m_c, logits.amax(dim=-1))
        p = torch.exp(logits - m_new.unsqueeze(-1))
        if causal:
            p = p * keep
        corr = torch.exp(m_c - m_new)
        parts.append((m_new, l[:, :, rows] * corr + p.sum(dim=-1),
                      acc[:, :, rows] * corr.unsqueeze(-1)
                      + torch.matmul(p, v32)))
    return tuple(torch.cat(x, dim=2) for x in zip(*parts))


def _xla_hop_bwd(q, k, v, do, lse, dsum, *, dq, dk, dv, q_offset, k_offset,
                 scale, causal, q_chunk):
    """The JAX ``_bwd`` body: this hop's dq, dk, dv folded into the
    carried f32 sums, q in chunks."""
    k32, v32 = k.float(), v.float()
    n_c, qc = _chunks(q_chunk, q.shape[2])
    dq_parts = []
    for c in range(n_c):
        rows = slice(c * qc, (c + 1) * qc)
        q_c, do_c = q[:, :, rows].float(), do[:, :, rows].float()
        logits = torch.matmul(q_c, k32.transpose(-1, -2)) * scale
        if causal:
            keep = _attention._hop_keep(qc, k.shape[2], q_offset + c * qc,
                                        k_offset, q.device)
            logits = logits.masked_fill(~keep, _NEG)
        p = torch.exp(logits - lse[:, :, rows].unsqueeze(-1))
        if causal:
            p = p * keep
        dv = dv + torch.matmul(p.transpose(-1, -2), do_c)
        dp = torch.matmul(do_c, v32.transpose(-1, -2))
        ds = p * (dp - dsum[:, :, rows].unsqueeze(-1)) * scale
        dq_parts.append(dq[:, :, rows] + torch.matmul(ds, k32))
        dk = dk + torch.matmul(ds.transpose(-1, -2), q_c)
    return torch.cat(dq_parts, dim=2), dk, dv


def _hops(impl, scale, causal, q_chunk):
    """``(forward hop, backward hop)``: ``fwd(q, k, v, m, l, acc, *,
    q_offset, k_offset)`` and ``bwd(q, k, v, do, lse, dsum, *, dq, dk,
    dv, q_offset, k_offset)``, each returning the carried tensors."""
    if impl == "flash":
        return (functools.partial(_attention.flash_hop_fwd, scale=scale,
                                  causal=causal),
                functools.partial(_attention.flash_hop_bwd, scale=scale,
                                  causal=causal))
    kw = dict(scale=scale, causal=causal, q_chunk=q_chunk)
    return (functools.partial(_xla_hop_fwd, **kw),
            functools.partial(_xla_hop_bwd, **kw))


def _ring_forward(ring, q5, k5, v5, hop):
    """The forward ring over this process's ranks; returns f32 ``out``
    and ``lse`` in the blocked layout."""
    n, ranks = ring.size, ring.ranks
    nl, b, h, tl, d = q5.shape
    qs = q5.unbind(0)
    m = list(torch.full((nl, b, h, tl), _NEG, dtype=torch.float32,
                        device=q5.device).unbind(0))
    l = list(torch.zeros((nl, b, h, tl), dtype=torch.float32,
                         device=q5.device).unbind(0))
    acc = list(torch.zeros(q5.shape, dtype=torch.float32,
                           device=q5.device).unbind(0))
    kb, vb = list(k5.unbind(0)), list(v5.unbind(0))
    for s in range(n):
        for i, r in enumerate(ranks):
            m[i], l[i], acc[i] = hop(
                qs[i], kb[i], vb[i], m[i], l[i], acc[i],
                q_offset=r * tl, k_offset=((r + s) % n) * tl)
        if s < n - 1:
            kb, vb = ring.shift(kb, vb)
    l5 = torch.stack(l).clamp_min(1e-30)
    out5 = torch.stack(acc) / l5.unsqueeze(-1)
    return out5, torch.stack(m) + torch.log(l5)


def _ring_backward(ring, q5, k5, v5, do5, lse5, dsum5, hop):
    """The reverse ring: f32 ``(dq, dk, dv)`` in the blocked layout."""
    n, ranks = ring.size, ring.ranks
    tl = q5.shape[3]
    dq, dk, dv = (list(torch.zeros(q5.shape, dtype=torch.float32,
                                   device=q5.device).unbind(0))
                  for _ in range(3))
    qs, dos, lses, dsums = (x.unbind(0) for x in (q5, do5, lse5, dsum5))
    kb, vb = list(k5.unbind(0)), list(v5.unbind(0))
    for s in range(n):
        for i, r in enumerate(ranks):
            dq[i], dk[i], dv[i] = hop(
                qs[i], kb[i], vb[i], dos[i], lses[i], dsums[i], dq=dq[i],
                dk=dk[i], dv=dv[i], q_offset=r * tl,
                k_offset=((r + s) % n) * tl)
        # dk/dv ride with their block: n hops bring them home
        if s < n - 1:
            kb, vb, dk, dv = ring.shift(kb, vb, dk, dv)
        else:
            dk, dv = ring.shift(dk, dv)
    return torch.stack(dq), torch.stack(dk), torch.stack(dv)


class _RingAttention(torch.autograd.Function):
    """``(q, k, v) -> out`` over a ring, with the reverse-ring backward;
    saves ``(q, k, v, out, lse)`` (blocked, out and lse in f32) as the
    JAX custom VJP does."""

    @staticmethod
    def forward(ctx, q, k, v, ring, scale, causal, q_chunk, impl):
        nl = len(ring.ranks)
        q5, k5, v5 = (_blocks(x, nl) for x in (q, k, v))
        fwd, _ = _hops(impl, scale, causal, q_chunk)
        out5, lse5 = _ring_forward(ring, q5, k5, v5, fwd)
        ctx.save_for_backward(q5, k5, v5, out5, lse5)
        ctx.args = (ring, scale, causal, q_chunk, impl)
        return _unblock(out5).to(q.dtype)

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        q5, k5, v5, out5, lse5 = ctx.saved_tensors
        ring, scale, causal, q_chunk, impl = ctx.args
        # dout in the input dtype (the cotangent of the f32 output upcast
        # and cast back, exactly), dsum = rowsum(f32 dout * f32 out)
        do5 = _blocks(dout.to(q5.dtype), len(ring.ranks))
        dsum5 = (do5.float() * out5).sum(dim=-1)
        _, bwd = _hops(impl, scale, causal, q_chunk)
        dq, dk, dv = _ring_backward(ring, q5, k5, v5, do5, lse5, dsum5, bwd)
        return (_unblock(dq).to(q5.dtype), _unblock(dk).to(k5.dtype),
                _unblock(dv).to(v5.dtype), None, None, None, None, None)


def ring_attention(q, k, v, *, axis_name, scale: float | None = None,
                   causal: bool = True, q_chunk: int | None = None,
                   impl: str = "xla"):
    """Exact (flash-accumulated) attention over a ring.

    Args:
      q, k, v: ``[B, T, H, D]``: this rank's block under a
        ``ProcessGroupRing``, the whole sequence under an
        ``InProcessRing`` (or ``axis_name=None``).
      axis_name: the name a ring is bound to (``sequence_sharded_apply``),
        a ring, or None for the one-rank ring.
      scale: logit scale; defaults to ``D ** -0.5``.
      causal: a causal mask in GLOBAL positions.
      q_chunk: ``impl="xla"`` only: process each hop's q block in chunks
        of this length (it must divide the block), bounding the transient
        logits to ``[B, H, q_chunk, T_local]``.
      impl: ``"xla"`` (composed products) or ``"flash"`` (the hop
        kernels).

    Returns ``[B, T, H, D]`` in ``q.dtype`` (all accumulation in f32).
    Differentiable in q, k, v, first order only.
    """
    if impl not in _IMPLS:
        raise ValueError(f"impl must be 'xla' or 'flash'; got {impl!r}")
    ring = resolve_ring(axis_name)
    if q.dim() != 4 or not q.shape == k.shape == v.shape:
        raise ValueError(
            f"q, k, v must share one [B, T, H, D] shape; got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    nl = len(ring.ranks)
    if q.shape[1] % nl:
        raise ValueError(f"sequence length {q.shape[1]} does not split "
                         f"into the {nl} ranks held here")
    _chunks(q_chunk, q.shape[1] // nl)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _RingAttention.apply(q, k, v, ring, float(scale), bool(causal),
                                None if q_chunk is None else int(q_chunk),
                                impl)


def ring_attn_fn(axis_name, causal: bool = True, q_chunk: int | None = None,
                 impl: str = "xla"):
    """An attention function (``TransformerLM.attn_fn`` signature,
    ``fn(q, k, v, *, scale)``) over the ring named ``axis_name``."""
    return functools.partial(ring_attention, axis_name=axis_name,
                             causal=causal, q_chunk=q_chunk, impl=impl)


def blockwise_attention(q, k, v, *, scale: float | None = None,
                        causal: bool = True, q_chunk: int | None = None):
    """Device-local flash-style attention: the ring of one rank.  The
    q chunks bound the transient logits to ``[B, H, q_chunk, T]`` and
    the backward recomputes them from the saved logsumexp."""
    return ring_attention(q, k, v, axis_name=None, scale=scale,
                          causal=causal, q_chunk=q_chunk)


def blockwise_attn_fn(causal: bool = True, q_chunk: int | None = 128):
    """An attention function running device-local blockwise attention
    (``q_chunk=128`` is the JAX package's default)."""
    return functools.partial(blockwise_attention, causal=causal,
                             q_chunk=q_chunk)


def sequence_sharded_apply(fn, ring, seq_axis: str, *,
                           num_seq_args: int = 1):
    """Wrap ``fn(params, *arrays)`` so that it runs with ``seq_axis``
    bound to ``ring`` (as ``shard_map`` binds a mesh axis).  Under a
    ``ProcessGroupRing`` the first ``num_seq_args`` array arguments are
    narrowed along axis 1 (time) to this rank's block, and the outputs
    are this rank's; under an ``InProcessRing`` the arguments pass whole.
    Arguments past ``num_seq_args`` pass unchanged."""

    def apply(params, *args):
        if len(ring.ranks) < ring.size:
            args = tuple(_rank_block(x, ring) if i < num_seq_args else x
                         for i, x in enumerate(args))
        with _bind(seq_axis, ring):
            return fn(params, *args)

    return apply


def _rank_block(x, ring):
    t = x.shape[1]
    if t % ring.size:
        raise ValueError(f"sequence length {t} does not split into "
                         f"{ring.size} ranks")
    tl = t // ring.size
    return x.narrow(1, ring.ranks[0] * tl, tl)
