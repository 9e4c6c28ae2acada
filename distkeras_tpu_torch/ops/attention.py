"""Flash attention: the hand-written Hopper kernels
(``csrc/flash_attention_fwd.cu``, ``csrc/flash_attention_bwd.cu``) and
their plain PyTorch versions, under one ``torch.autograd.Function``;
and the ring-hop kernels (``csrc/flash_hop.cu``) that
``parallel.ring_attention`` runs once per hop.

Port of ``distkeras_tpu/ops/attention.py`` ``flash_attention`` /
``flash_attn_fn`` with its custom VJP, and of ``flash_hop_fwd`` /
``flash_hop_bwd``.  Public functions keep the JAX package's
``[B, T, H, D]`` layout; the kernels and the plain versions work on
``[B, H, T, D]``, as the TPU kernels do.

A CUDA tensor goes to the kernels, or the call raises; a CPU tensor
goes to the plain versions (forward and backward).  ``launches`` counts
forward kernel launches, ``bwd_dq_launches`` and ``bwd_dkv_launches``
the two backward kernels', ``hop_fwd_launches``, ``hop_dq_launches``
and ``hop_dkv_launches`` the hop kernels', and nothing else.  The
backward is first-order only (``once_differentiable``), as the JAX VJP
is.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch
from torch.autograd.function import once_differentiable

_NEG = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)

#: forward kernel launches since the last reset (``launches = 0``)
launches = 0
#: backward kernel launches since the last reset
bwd_dq_launches = 0
bwd_dkv_launches = 0
#: ring-hop kernel launches since the last reset
hop_fwd_launches = 0
hop_dq_launches = 0
hop_dkv_launches = 0

#: guards the counters: worker threads launch kernels concurrently, and a
#: bare ``+= 1`` on a module global can lose counts between threads
_count_lock = threading.Lock()


def _note(*counters: str) -> None:
    """Add one to each named counter of this module, under
    ``_count_lock``."""
    g = globals()
    with _count_lock:
        for name in counters:
            g[name] += 1


def _causal_keep(t: int, device) -> torch.Tensor:
    return torch.ones(t, t, dtype=torch.bool, device=device).tril()


def _hop_keep(tq: int, tk: int, q_offset: int, k_offset: int, device):
    """``[Tq, Tk]`` causal mask in GLOBAL positions (``_off_mask``)."""
    rows = q_offset + torch.arange(tq, device=device)
    cols = k_offset + torch.arange(tk, device=device)
    return rows[:, None] >= cols[None, :]


def flash_attention_reference(q, k, v, *, scale: float,
                              causal: bool = True):
    """Plain version on ``[B, H, T, D]``: returns ``(out, lse)`` with
    ``out`` in the input dtype and ``lse`` ``[B, H, T]`` f32.  The same
    arithmetic as the kernel: f32 logits and statistics, ``-1e30``
    masking, P rounded to the input dtype before P.V, normalization
    after it."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        logits = logits.masked_fill(~_causal_keep(q.shape[-2], q.device),
                                    _NEG)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    acc = torch.matmul(p.to(q.dtype).float(), v.float())
    out = (acc / l).to(q.dtype)
    return out, (m + torch.log(l)).squeeze(-1)


def _probs(q, k, lse, scale, keep):
    """f32 ``p = exp(logits - lse)`` (``[B,H,Tq,Tk]``), zero where the
    mask ``keep`` (None: no mask) is False."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if keep is None:
        return torch.exp(logits - lse.unsqueeze(-1))
    p = torch.exp(logits.masked_fill(~keep, _NEG) - lse.unsqueeze(-1))
    return p.masked_fill(~keep, 0.0)


def _ds(q, k, v, do, lse, dsum, scale, keep):
    """``(p, ds)`` in f32: ``ds = p * (dp - dsum) * scale``."""
    p = _probs(q, k, lse, scale, keep)
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    return p, p * (dp - dsum.unsqueeze(-1)) * scale


def _local_keep(q, causal):
    return _causal_keep(q.shape[-2], q.device) if causal else None


def flash_attention_bwd_dq_reference(q, k, v, do, lse, dsum, *,
                                     scale: float, causal: bool = True):
    """Plain version of the dq kernel (``_dq_kernel``): ``do`` already
    in the input dtype, ``lse``/``dsum`` ``[B, H, T]`` f32.  ds is
    rounded to the input dtype before ds.k; dq accumulates in f32."""
    _, ds = _ds(q, k, v, do, lse, dsum, scale, _local_keep(q, causal))
    return torch.matmul(ds.to(q.dtype).float(), k.float()).to(q.dtype)


def flash_attention_bwd_dkv_reference(q, k, v, do, lse, dsum, *,
                                      scale: float, causal: bool = True):
    """Plain version of the dk/dv kernel (``_dkv_kernel``): p rounded to
    the input dtype before p^T.do, ds before ds^T.q; f32 sums."""
    p, ds = _ds(q, k, v, do, lse, dsum, scale, _local_keep(q, causal))
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), q.float())
    dv = torch.matmul(p.to(q.dtype).float().transpose(-1, -2), do.float())
    return dk.to(q.dtype), dv.to(q.dtype)


def _bwd_inputs(q, out, dout):
    """``(do, dsum)``: ``dout`` in the input dtype and the
    softmax-jacobian diagonal ``rowsum(f32(dout) * f32(out))``, computed
    outside the kernels as the JAX VJP does (``attention.py:335``)."""
    dsum = (dout.float() * out.float()).sum(-1).contiguous()
    return dout.to(q.dtype).contiguous(), dsum


def flash_attention_bwd_reference(q, k, v, out, lse, dout, *,
                                  scale: float, causal: bool = True):
    """Plain backward on ``[B, H, T, D]``: ``(dq, dk, dv)`` in the input
    dtype, repeating the TPU kernels' arithmetic."""
    do, dsum = _bwd_inputs(q, out, dout)
    dq = flash_attention_bwd_dq_reference(q, k, v, do, lse, dsum,
                                          scale=scale, causal=causal)
    dk, dv = flash_attention_bwd_dkv_reference(q, k, v, do, lse, dsum,
                                               scale=scale, causal=causal)
    return dq, dk, dv


def _check(q, k, v):
    if not (q.shape == k.shape == v.shape) or q.dim() != 4:
        raise ValueError(
            f"q, k, v must share one [B, H, T, D] shape; got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(
            f"q, k, v must share a dtype in {list(_DTYPES)}; got "
            f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must lie on one device")


def _check_kernel_inputs(*tensors):
    d = tensors[0].shape[-1]
    if d not in _HEAD_DIMS:
        raise ValueError(
            f"the CUDA kernel is built for head sizes {_HEAD_DIMS}; "
            f"got {d}")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("the CUDA kernels need contiguous inputs")


def _launch(fn, name, device, *args):
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: error {err}")


def _kernel(q, k, v, *, scale: float, causal: bool):
    b, h, t, d = q.shape
    _check_kernel_inputs(q, k, v)
    lib = _library("flash_attention_fwd")
    out = torch.empty_like(q)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    _launch(lib.flash_attention_fwd, "flash_attention_fwd", q.device,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, h, t, d, float(scale), int(bool(causal)),
            _DTYPES[q.dtype])
    _note("launches")
    return out, lse


def _bwd_ptrs(q, k, v, do, lse, dsum):
    _check_device(q, k, v, do)
    _check_kernel_inputs(q, k, v, do)
    for name, x in (("lse", lse), ("dsum", dsum)):
        _check_f32(name, x, q.shape[:3], q.device)
    return [x.data_ptr() for x in (q, k, v, do, lse, dsum)]


def _dq_kernel(q, k, v, do, lse, dsum, *, scale: float, causal: bool):
    b, h, t, d = q.shape
    ptrs = _bwd_ptrs(q, k, v, do, lse, dsum)
    lib = _library("flash_attention_bwd")
    dq = torch.empty_like(q)
    _launch(lib.flash_attention_bwd_dq, "flash_attention_bwd_dq", q.device,
            *ptrs, dq.data_ptr(), b, h, t, d, float(scale),
            int(bool(causal)), _DTYPES[q.dtype])
    _note("bwd_dq_launches")
    return dq


def _dkv_kernel(q, k, v, do, lse, dsum, *, scale: float,
                causal: bool):
    b, h, t, d = q.shape
    ptrs = _bwd_ptrs(q, k, v, do, lse, dsum)
    lib = _library("flash_attention_bwd")
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch(lib.flash_attention_bwd_dkv, "flash_attention_bwd_dkv",
            q.device, *ptrs, dk.data_ptr(), dv.data_ptr(), b, h, t, d,
            float(scale), int(bool(causal)), _DTYPES[q.dtype])
    _note("bwd_dkv_launches")
    return dk, dv


_PTR, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _args(n_ptrs: int, n_ints: int, n_flags: int) -> list:
    """Pointers, ints (sizes, offsets), the scale, int flags (causal,
    accumulate, dtype) and the stream."""
    return ([_PTR] * n_ptrs + [_INT] * n_ints + [_FLOAT]
            + [_INT] * n_flags + [_PTR])


# source -> {entry point: its ctypes argument types}
_ENTRY_POINTS = {
    "flash_attention_fwd": {"flash_attention_fwd": _args(5, 4, 2)},
    "flash_attention_bwd": {"flash_attention_bwd_dq": _args(7, 4, 2),
                            "flash_attention_bwd_dkv": _args(8, 4, 2)},
    # B, H, Tq, Tk, D, q_offset, k_offset
    "flash_hop": {"flash_hop_fwd": _args(6, 7, 2),
                  "flash_hop_bwd_dq": _args(7, 7, 3),
                  "flash_hop_bwd_dkv": _args(8, 7, 3)},
}


@functools.lru_cache(maxsize=None)
def _library(source: str):
    from distkeras_tpu_torch.ops import _build

    lib = _build.load(source)
    for name, argtypes in _ENTRY_POINTS[source].items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _INT
    return lib


def _on(device, kernel, reference):
    if device.type == "cuda":
        return kernel
    if device.type != "cpu":
        raise ValueError(f"no flash attention for device {device}")
    return reference


def flash_attention_bwd_dq(q, k, v, do, lse, dsum, *, scale: float,
                           causal: bool = True):
    """dq: the dq kernel for CUDA tensors, its plain version for CPU
    tensors."""
    fn = _on(q.device, _dq_kernel, flash_attention_bwd_dq_reference)
    return fn(q, k, v, do, lse, dsum, scale=float(scale),
              causal=bool(causal))


def flash_attention_bwd_dkv(q, k, v, do, lse, dsum, *, scale: float,
                            causal: bool = True):
    """(dk, dv): the dk/dv kernel for CUDA tensors, its plain version for
    CPU tensors."""
    fn = _on(q.device, _dkv_kernel, flash_attention_bwd_dkv_reference)
    return fn(q, k, v, do, lse, dsum, scale=float(scale),
              causal=bool(causal))


def flash_attention_bwd_bhtd(q, k, v, out, lse, dout, *, scale: float,
                             causal: bool = True):
    """The backward on ``[B, H, T, D]``: ``(dq, dk, dv)`` from the saved
    forward (``out``, ``lse``) and the output cotangent ``dout``."""
    do, dsum = _bwd_inputs(q, out, dout)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, dsum, scale=scale,
                                causal=causal)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, dsum, scale=scale,
                                     causal=causal)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """``(q, k, v) -> (out, lse)`` with the hand-written backward; saves
    ``q, k, v, out, lse`` as the JAX VJP's ``_flash_fwd`` does."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal):
        fn = _on(q.device, _kernel, flash_attention_reference)
        out, lse = fn(q, k, v, scale=scale, causal=causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale, ctx.causal = scale, causal
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    @once_differentiable
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        if dout is None:
            dout = torch.zeros_like(out)
        dq, dk, dv = flash_attention_bwd_bhtd(
            q, k, v, out, lse, dout, scale=ctx.scale, causal=ctx.causal)
        return dq, dk, dv, None, None


def flash_attention_bhtd(q, k, v, *, scale: float, causal: bool = True):
    """``[B, H, T, D]`` -> ``(out, lse)``, differentiable in ``q, k, v``:
    the kernels for CUDA tensors, the plain versions for CPU tensors."""
    _check(q, k, v)
    return _FlashAttention.apply(q, k, v, float(scale), bool(causal))


def flash_attention(q, k, v, *, scale: float | None = None,
                    causal: bool = True):
    """Flash attention ``[B, T, H, D] -> [B, T, H, D]``; the same
    contract as ``models.transformer.dense_causal_attention``."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    out, _ = flash_attention_bhtd(qt, kt, vt, scale=float(scale),
                                  causal=causal)
    return out.transpose(1, 2)


def flash_attn_fn(causal: bool = True):
    """An attention function (``TransformerLM`` attention signature)
    running the flash kernels."""
    return functools.partial(flash_attention, causal=causal)


# ---------------------------------------------------------------------
# Ring-hop kernels (kernels #3-#4): the online-softmax state (m, l, acc)
# is carried in and out instead of finalized, and the causal mask takes
# the blocks' GLOBAL positions q_offset, k_offset.  One call is one hop
# of parallel.ring_attention: the resident q block against a visiting
# k/v block.  A masked p is exactly 0 here and in the kernels; the TPU
# forward leaves exp(0) there, which no ring hop reaches (the diagonal
# hop runs first, and its first tile holds each row's own block start,
# so m is finite before any tile without a visible key).
# ---------------------------------------------------------------------


def _hop_mask(q, k, q_offset, k_offset, causal):
    if not causal:
        return None
    return _hop_keep(q.shape[-2], k.shape[-2], q_offset, k_offset, q.device)


def flash_hop_fwd_reference(q, k, v, m, l, acc, *, q_offset: int,
                            k_offset: int, scale: float,
                            causal: bool = True):
    """Plain version of the hop forward kernel (``_hop_fwd_kernel``):
    q ``[B, H, Tq, D]``, k/v ``[B, H, Tk, D]``, the f32 state m, l
    ``[B, H, Tq]`` and acc ``[B, H, Tq, D]``; returns the new state.
    f32 logits, ``-1e30`` masking, P rounded to v's dtype before P.V
    while l sums the unrounded P."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    keep = _hop_mask(q, k, q_offset, k_offset, causal)
    if keep is not None:
        logits = logits.masked_fill(~keep, _NEG)
    m_new = torch.maximum(m, logits.amax(dim=-1))
    p = torch.exp(logits - m_new.unsqueeze(-1))
    if keep is not None:
        p = p.masked_fill(~keep, 0.0)
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1)
    acc_new = acc * corr.unsqueeze(-1) + torch.matmul(
        p.to(v.dtype).float(), v.float())
    return m_new, l_new, acc_new


def flash_hop_bwd_dq_reference(q, k, v, do, lse, dsum, *, q_offset: int,
                               k_offset: int, scale: float,
                               causal: bool = True, dq=None):
    """Plain version of the hop dq kernel (``_hop_dq_kernel``): ``do`` in
    the input dtype, the FINAL ``lse`` and ``dsum`` ``[B, H, Tq]`` f32.
    ds is rounded to k's dtype before ds.k.  Returns this hop's f32
    partial dq, added to the carried ``dq`` when one is given."""
    _, ds = _ds(q, k, v, do, lse, dsum, scale,
                _hop_mask(q, k, q_offset, k_offset, causal))
    part = torch.matmul(ds.to(k.dtype).float(), k.float())
    return part if dq is None else dq + part


def flash_hop_bwd_dkv_reference(q, k, v, do, lse, dsum, *, q_offset: int,
                                k_offset: int, scale: float,
                                causal: bool = True, dk=None, dv=None):
    """Plain version of the hop dk/dv kernel (``_hop_dkv_kernel``): p
    rounded to do's dtype before p^T.do, ds to q's dtype before ds^T.q.
    Returns this hop's f32 partials ``(dk, dv)``, added to the carried
    ``dk``, ``dv`` when given."""
    p, ds = _ds(q, k, v, do, lse, dsum, scale,
                _hop_mask(q, k, q_offset, k_offset, causal))
    dk_p = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), q.float())
    dv_p = torch.matmul(p.to(do.dtype).float().transpose(-1, -2),
                        do.float())
    if dk is None:
        return dk_p, dv_p
    return dk + dk_p, dv + dv_p


def _check_hop(q, k, v, *extra):
    """q ``[B, H, Tq, D]`` and k, v ``[B, H, Tk, D]`` of one dtype the
    kernels take, contiguous; ``extra`` tensors contiguous too, and all
    on q's device."""
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 \
            or q.shape[:2] != k.shape[:2] or q.shape[-1] != k.shape[-1]:
        raise ValueError(
            f"q [B, H, Tq, D] and k, v [B, H, Tk, D] expected; got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(
            f"q, k, v must share a dtype in {list(_DTYPES)}; got "
            f"{q.dtype}, {k.dtype}, {v.dtype}")
    _check_device(q, k, v, *extra)
    _check_kernel_inputs(q, k, v, *extra)


def _check_device(q, *tensors):
    if any(x.device != q.device for x in tensors):
        raise ValueError(f"k, v and do must lie on q's device {q.device}; "
                         f"got {[str(x.device) for x in tensors]}")


def _check_f32(name, x, shape, device):
    """A kernel's f32 side tensor (lse, dsum, hop state, carried sums):
    its pointer goes to the kernel as it is, so it must lie on q's
    device, contiguous, at its shape."""
    if x.dtype != torch.float32 or tuple(x.shape) != tuple(shape) \
            or not x.is_contiguous():
        raise ValueError(f"{name} must be a contiguous f32 "
                         f"{list(shape)} tensor; got {x.dtype} "
                         f"{list(x.shape)}")
    if x.device != device:
        raise ValueError(f"{name} must lie on q's device {device}; got "
                         f"{x.device}")


def _hop_sizes(q, k):
    b, h, tq, d = q.shape
    return b, h, tq, k.shape[2], d


def _hop_fwd_kernel(q, k, v, m, l, acc, *, q_offset: int, k_offset: int,
                    scale: float, causal: bool):
    _check_hop(q, k, v)
    for name, x, shape in (("m", m, q.shape[:3]), ("l", l, q.shape[:3]),
                           ("acc", acc, q.shape)):
        _check_f32(name, x, shape, q.device)
    lib = _library("flash_hop")
    _launch(lib.flash_hop_fwd, "flash_hop_fwd", q.device,
            *(x.data_ptr() for x in (q, k, v, m, l, acc)),
            *_hop_sizes(q, k), q_offset, k_offset, scale, int(causal),
            _DTYPES[q.dtype])
    _note("hop_fwd_launches")
    return m, l, acc


def _hop_bwd_ptrs(q, k, v, do, lse, dsum):
    _check_hop(q, k, v, do)
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError("do must have q's shape and dtype")
    for name, x in (("lse", lse), ("dsum", dsum)):
        _check_f32(name, x, q.shape[:3], q.device)
    return [x.data_ptr() for x in (q, k, v, do, lse, dsum)]


def _hop_dq_kernel(q, k, v, do, lse, dsum, *, q_offset: int,
                   k_offset: int, scale: float, causal: bool, dq=None):
    ptrs = _hop_bwd_ptrs(q, k, v, do, lse, dsum)
    accumulate = dq is not None
    if accumulate:
        _check_f32("dq", dq, q.shape, q.device)
    else:
        dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    lib = _library("flash_hop")
    _launch(lib.flash_hop_bwd_dq, "flash_hop_bwd_dq", q.device, *ptrs,
            dq.data_ptr(), *_hop_sizes(q, k), q_offset, k_offset, scale,
            int(causal), int(accumulate), _DTYPES[q.dtype])
    _note("hop_dq_launches")
    return dq


def _hop_dkv_kernel(q, k, v, do, lse, dsum, *, q_offset: int,
                    k_offset: int, scale: float, causal: bool, dk=None,
                    dv=None):
    ptrs = _hop_bwd_ptrs(q, k, v, do, lse, dsum)
    if (dk is None) != (dv is None):
        raise ValueError("carry both dk and dv, or neither")
    accumulate = dk is not None
    if accumulate:
        _check_f32("dk", dk, k.shape, q.device)
        _check_f32("dv", dv, v.shape, q.device)
    else:
        dk, dv = (torch.empty(k.shape, dtype=torch.float32, device=k.device)
                  for _ in range(2))
    lib = _library("flash_hop")
    _launch(lib.flash_hop_bwd_dkv, "flash_hop_bwd_dkv", q.device, *ptrs,
            dk.data_ptr(), dv.data_ptr(), *_hop_sizes(q, k), q_offset,
            k_offset, scale, int(causal), int(accumulate), _DTYPES[q.dtype])
    _note("hop_dkv_launches")
    return dk, dv


def _hop_kw(q_offset, k_offset, scale, causal):
    return dict(q_offset=int(q_offset), k_offset=int(k_offset),
                scale=float(scale), causal=bool(causal))


def flash_hop_fwd(q, k, v, m, l, acc, *, q_offset: int, k_offset: int,
                  scale: float, causal: bool = True):
    """One ring hop of flash attention, state carried: returns the
    updated ``(m, l, acc)`` (see ``flash_hop_fwd_reference``).  The
    kernel for CUDA tensors updates the state IN PLACE and returns it;
    the plain version for CPU tensors returns new tensors.  The caller
    finalizes with ``out = acc / max(l, 1e-30)`` and ``lse = m + log l``
    after the last hop."""
    fn = _on(q.device, _hop_fwd_kernel, flash_hop_fwd_reference)
    return fn(q, k, v, m, l, acc, **_hop_kw(q_offset, k_offset, scale,
                                            causal))


def flash_hop_bwd_dq(q, k, v, do, lse, dsum, *, q_offset: int,
                     k_offset: int, scale: float, causal: bool = True,
                     dq=None):
    """This hop's f32 partial dq, added to the carried ``dq`` when
    given (in place by the kernel for CUDA tensors)."""
    fn = _on(q.device, _hop_dq_kernel, flash_hop_bwd_dq_reference)
    return fn(q, k, v, do, lse, dsum, dq=dq,
              **_hop_kw(q_offset, k_offset, scale, causal))


def flash_hop_bwd_dkv(q, k, v, do, lse, dsum, *, q_offset: int,
                      k_offset: int, scale: float, causal: bool = True,
                      dk=None, dv=None):
    """This hop's f32 partials ``(dk, dv)``, added to the carried ``dk``,
    ``dv`` when given (in place by the kernel for CUDA tensors)."""
    fn = _on(q.device, _hop_dkv_kernel, flash_hop_bwd_dkv_reference)
    return fn(q, k, v, do, lse, dsum, dk=dk, dv=dv,
              **_hop_kw(q_offset, k_offset, scale, causal))


def flash_hop_bwd(q, k, v, do, lse, dsum, *, q_offset: int, k_offset: int,
                  scale: float, causal: bool = True, dq=None, dk=None,
                  dv=None):
    """One ring hop of the flash backward: ``(dq, dk, dv)``, this hop's
    f32 partials for the (local q) x (visiting k/v) pair, each added to
    its carried sum when given.  ``lse`` is the FINAL logsumexp and
    ``dsum`` is rowsum(dO.O), both ``[B, H, Tq]`` f32."""
    kw = _hop_kw(q_offset, k_offset, scale, causal)
    dq = flash_hop_bwd_dq(q, k, v, do, lse, dsum, dq=dq, **kw)
    dk, dv = flash_hop_bwd_dkv(q, k, v, do, lse, dsum, dk=dk, dv=dv, **kw)
    return dq, dk, dv
