"""Flash attention: the hand-written Hopper kernels
(``csrc/flash_attention_fwd.cu``, ``csrc/flash_attention_bwd.cu``) and
their plain PyTorch versions, under one ``torch.autograd.Function``.

Port of ``distkeras_tpu/ops/attention.py`` ``flash_attention`` /
``flash_attn_fn`` with its custom VJP.  Public functions keep the JAX
package's ``[B, T, H, D]`` layout; the kernels and the plain versions
work on ``[B, H, T, D]``, as the TPU kernels do.

A CUDA tensor goes to the kernels, or the call raises; a CPU tensor
goes to the plain versions (forward and backward).  ``launches`` counts
forward kernel launches, ``bwd_dq_launches`` and ``bwd_dkv_launches``
the two backward kernels', and nothing else.  The backward is
first-order only (``once_differentiable``), as the JAX VJP is.
"""

from __future__ import annotations

import ctypes
import functools

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


def _causal_keep(t: int, device) -> torch.Tensor:
    return torch.ones(t, t, dtype=torch.bool, device=device).tril()


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


def _probs(q, k, lse, scale, causal):
    """f32 ``p = exp(logits - lse)``, zero where masked (``[B,H,T,T]``)."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if not causal:
        return torch.exp(logits - lse.unsqueeze(-1))
    keep = _causal_keep(q.shape[-2], q.device)
    p = torch.exp(logits.masked_fill(~keep, _NEG) - lse.unsqueeze(-1))
    return p.masked_fill(~keep, 0.0)


def _ds(q, k, v, do, lse, dsum, scale, causal):
    """``(p, ds)`` in f32: ``ds = p * (dp - dsum) * scale``."""
    p = _probs(q, k, lse, scale, causal)
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    return p, p * (dp - dsum.unsqueeze(-1)) * scale


def flash_attention_bwd_dq_reference(q, k, v, do, lse, dsum, *,
                                     scale: float, causal: bool = True):
    """Plain version of the dq kernel (``_dq_kernel``): ``do`` already
    in the input dtype, ``lse``/``dsum`` ``[B, H, T]`` f32.  ds is
    rounded to the input dtype before ds.k; dq accumulates in f32."""
    _, ds = _ds(q, k, v, do, lse, dsum, scale, causal)
    return torch.matmul(ds.to(q.dtype).float(), k.float()).to(q.dtype)


def flash_attention_bwd_dkv_reference(q, k, v, do, lse, dsum, *,
                                      scale: float, causal: bool = True):
    """Plain version of the dk/dv kernel (``_dkv_kernel``): p rounded to
    the input dtype before p^T.do, ds before ds^T.q; f32 sums."""
    p, ds = _ds(q, k, v, do, lse, dsum, scale, causal)
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
    global launches
    b, h, t, d = q.shape
    _check_kernel_inputs(q, k, v)
    lib = _library("flash_attention_fwd")
    out = torch.empty_like(q)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    _launch(lib.flash_attention_fwd, "flash_attention_fwd", q.device,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, h, t, d, float(scale), int(bool(causal)),
            _DTYPES[q.dtype])
    launches += 1
    return out, lse


def _bwd_ptrs(q, k, v, do, lse, dsum):
    _check_kernel_inputs(q, k, v, do)
    if lse.dtype != torch.float32 or dsum.dtype != torch.float32 \
            or lse.shape != q.shape[:3] or dsum.shape != q.shape[:3] \
            or not (lse.is_contiguous() and dsum.is_contiguous()):
        raise ValueError("lse and dsum must be contiguous [B, H, T] f32")
    return [x.data_ptr() for x in (q, k, v, do, lse, dsum)]


def _dq_kernel(q, k, v, do, lse, dsum, *, scale: float, causal: bool):
    global bwd_dq_launches
    b, h, t, d = q.shape
    ptrs = _bwd_ptrs(q, k, v, do, lse, dsum)
    lib = _library("flash_attention_bwd")
    dq = torch.empty_like(q)
    _launch(lib.flash_attention_bwd_dq, "flash_attention_bwd_dq", q.device,
            *ptrs, dq.data_ptr(), b, h, t, d, float(scale),
            int(bool(causal)), _DTYPES[q.dtype])
    bwd_dq_launches += 1
    return dq


def _dkv_kernel(q, k, v, do, lse, dsum, *, scale: float,
                causal: bool):
    global bwd_dkv_launches
    b, h, t, d = q.shape
    ptrs = _bwd_ptrs(q, k, v, do, lse, dsum)
    lib = _library("flash_attention_bwd")
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch(lib.flash_attention_bwd_dkv, "flash_attention_bwd_dkv",
            q.device, *ptrs, dk.data_ptr(), dv.data_ptr(), b, h, t, d,
            float(scale), int(bool(causal)), _DTYPES[q.dtype])
    bwd_dkv_launches += 1
    return dk, dv


# source -> {entry point: its pointer arguments}; each entry point then
# takes B, H, T, D, scale, causal, dtype and the stream
_ENTRY_POINTS = {
    "flash_attention_fwd": {"flash_attention_fwd": 5},
    "flash_attention_bwd": {"flash_attention_bwd_dq": 7,
                            "flash_attention_bwd_dkv": 8},
}


@functools.lru_cache(maxsize=None)
def _library(source: str):
    from distkeras_tpu_torch.ops import _build

    ptr, int_ = ctypes.c_void_p, ctypes.c_int
    lib = _build.load(source)
    for name, n_ptrs in _ENTRY_POINTS[source].items():
        fn = getattr(lib, name)
        fn.argtypes = ([ptr] * n_ptrs + [int_] * 4
                       + [ctypes.c_float, int_, int_, ptr])
        fn.restype = int_
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
