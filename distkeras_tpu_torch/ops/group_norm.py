"""GroupNorm with an optional fused ReLU: the hand-written Hopper kernels
(``csrc/group_norm.cu``) and their plain PyTorch versions, under one
``torch.autograd.Function``.

Port of ``distkeras_tpu/ops/pallas_kernels.py`` (``fused_group_norm``,
its ``_fwd_kernel``/``_bwd_kernel`` and ``jax.custom_vjp``): the same
functions, on the card as CUDA kernels.  Both directions keep the TPU
kernels' algebra: f32 statistics as E[x^2] - E[x]^2 clamped at 0,
``inv = rsqrt(var + eps)``, ``y = x * scale + shift``, the strict
``z > 0`` ReLU test recomputed in the backward from the saved mean and
inv-std, one rounding of the output to x's dtype.

Layout contract.  The kernels read ``[B, HW, C]`` with channels
contiguous: ``group_norm`` takes the model's ``[B, C, *spatial]``
tensors in channels-last memory (``torch.channels_last`` for images),
whose ``movedim(1, -1)`` is exactly that buffer, so no copy is made on
the way in.  On a CUDA tensor any other layout raises.  The incoming
gradient of the backward may arrive in another memory format; it is
made channels-last with one explicit copy, counted in
``gradient_copies``.

A CUDA tensor goes to the kernels or the call raises; a CPU tensor
goes to the plain versions (forward and backward).  ``fwd_launches``
and ``bwd_launches`` count calls of the forward and backward kernel
entry points (each launches a statistics grid and an apply grid), and
nothing else.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.autograd.function import once_differentiable

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: channels the kernels take at most (their shared-memory staging)
MAX_CHANNELS = 4096
#: elements of a block's row tile
TILE_ELEMS = 16384

#: forward kernel launches since the last reset (``fwd_launches = 0``)
fwd_launches = 0
#: backward kernel launches since the last reset
bwd_launches = 0
#: explicit channels-last copies of an incoming gradient
gradient_copies = 0


def _check(x3, gamma, beta, groups):
    if x3.dim() != 3:
        raise ValueError(f"group norm takes [B, HW, C]; got {tuple(x3.shape)}")
    c = x3.shape[-1]
    if c % groups:
        raise ValueError(f"channels={c} not divisible by groups={groups}")
    if x3.dtype not in _DTYPES:
        raise TypeError(f"group norm takes {list(_DTYPES)}; got {x3.dtype}")
    for name, p in (("gamma", gamma), ("beta", beta)):
        if p.shape != (c,) or p.dtype != torch.float32 \
                or p.device != x3.device:
            raise ValueError(f"{name} must be [C]={c} f32 on {x3.device}; "
                             f"got {tuple(p.shape)} {p.dtype} {p.device}")


def _per_channel(stat, c):
    """``[B, G]`` group statistic -> ``[B, 1, C]``."""
    return stat.repeat_interleave(c // stat.shape[-1], dim=-1)[:, None, :]


def _group_sum(s, groups):
    """``[B, C]`` channel sums -> ``[B, G]`` group sums."""
    return s.view(s.shape[0], groups, -1).sum(-1)


def _count(x3, groups) -> float:
    return float(x3.shape[1] * (x3.shape[2] // groups))


def group_norm_fwd_reference(x3, gamma, beta, *, groups: int,
                             eps: float = 1e-6, relu: bool = False):
    """Plain forward on ``[B, HW, C]``: ``(y, mean, inv)`` with ``y`` in
    x's dtype and ``mean``, ``inv`` ``[B, G]`` f32; the kernel's
    arithmetic (``_fwd_kernel``)."""
    _check(x3, gamma, beta, groups)
    c = x3.shape[-1]
    count = _count(x3, groups)
    x = x3.float()
    mean = _group_sum(x.sum(1), groups) / count
    var = torch.clamp(_group_sum((x * x).sum(1), groups) / count
                      - mean * mean, min=0.0)
    inv = torch.rsqrt(var + eps)
    scale = _per_channel(inv, c) * gamma
    shift = beta - _per_channel(mean, c) * scale
    y = x * scale + shift
    if relu:
        y = torch.clamp(y, min=0.0)
    return y.to(x3.dtype), mean, inv


def group_norm_bwd_reference(x3, dy3, gamma, beta, mean, inv, *,
                             groups: int, relu: bool = False):
    """Plain backward on ``[B, HW, C]``: ``(dx, dgamma_b, dbeta_b)`` with
    ``dx`` in x's dtype and the per-image ``[B, C]`` f32 parameter
    gradients (``_bwd_kernel``)."""
    _check(x3, gamma, beta, groups)
    c = x3.shape[-1]
    count = _count(x3, groups)
    mean_c, inv_c = _per_channel(mean, c), _per_channel(inv, c)
    xhat = (x3.float() - mean_c) * inv_c
    dy = dy3.float()
    if relu:
        dy = torch.where(xhat * gamma + beta > 0, dy, 0.0)
    dgamma_b = (dy * xhat).sum(1)
    dbeta_b = dy.sum(1)
    dyg = dy * gamma
    t1 = _per_channel(_group_sum(dyg.sum(1), groups), c)
    t2 = _per_channel(_group_sum((dyg * xhat).sum(1), groups), c)
    dx = inv_c * (dyg - t1 / count - xhat * (t2 / count))
    return dx.to(x3.dtype), dgamma_b, dbeta_b


def _check_kernel_inputs(*tensors):
    c = tensors[0].shape[-1]
    if c > MAX_CHANNELS:
        raise ValueError(f"the CUDA kernels take at most {MAX_CHANNELS} "
                         f"channels; got {c}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the CUDA kernels need contiguous [B, HW, C] "
                         "inputs (channels-last memory)")


def _tiling(x3):
    """``(rows per tile, tiles per image)`` of the kernels' grid."""
    hw, c = x3.shape[1], x3.shape[2]
    rows = max(1, min(hw, TILE_ELEMS // c))
    return rows, -(-hw // rows)


def _launch(fn, name, device, *args):
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: error {err}")


def _fwd_kernel(x3, gamma, beta, *, groups: int, eps: float, relu: bool):
    global fwd_launches
    _check_kernel_inputs(x3, gamma, beta)
    b, hw, c = x3.shape
    rows, tiles = _tiling(x3)
    dev = x3.device
    y = torch.empty_like(x3)
    mean = torch.empty((b, groups), dtype=torch.float32, device=dev)
    inv = torch.empty_like(mean)
    part = torch.empty((b, tiles, 2, groups), dtype=torch.float32,
                       device=dev)
    _launch(_library().group_norm_fwd, "group_norm_fwd", dev,
            x3.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
            mean.data_ptr(), inv.data_ptr(), part.data_ptr(), b, hw, c,
            groups, rows, _count(x3, groups), float(eps), int(relu),
            _DTYPES[x3.dtype])
    fwd_launches += 1
    return y, mean, inv


def _bwd_kernel(x3, dy3, gamma, beta, mean, inv, *, groups: int,
                relu: bool):
    global bwd_launches
    _check_kernel_inputs(x3, dy3, gamma, beta, mean, inv)
    if dy3.shape != x3.shape or dy3.dtype != x3.dtype:
        raise ValueError("dy must match x in shape and dtype")
    b, hw, c = x3.shape
    if mean.shape != (b, groups) or inv.shape != (b, groups):
        raise ValueError(f"mean and inv must be [B, G]=[{b}, {groups}]")
    rows, tiles = _tiling(x3)
    dev = x3.device
    dx = torch.empty_like(x3)
    dgamma_b = torch.empty((b, c), dtype=torch.float32, device=dev)
    dbeta_b = torch.empty_like(dgamma_b)
    part = torch.empty((b, tiles, 2, c), dtype=torch.float32, device=dev)
    _launch(_library().group_norm_bwd, "group_norm_bwd", dev,
            x3.data_ptr(), dy3.data_ptr(), gamma.data_ptr(),
            beta.data_ptr(), mean.data_ptr(), inv.data_ptr(),
            dx.data_ptr(), dgamma_b.data_ptr(), dbeta_b.data_ptr(),
            part.data_ptr(), b, hw, c, groups, rows, _count(x3, groups),
            int(relu), _DTYPES[x3.dtype])
    bwd_launches += 1
    return dx, dgamma_b, dbeta_b


@functools.lru_cache(maxsize=None)
def _library():
    from distkeras_tpu_torch.ops import _build

    ptr, int_, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib = _build.load("group_norm")
    lib.group_norm_fwd.argtypes = ([ptr] * 7 + [int_] * 5
                                   + [f32, f32, int_, int_, ptr])
    lib.group_norm_fwd.restype = int_
    lib.group_norm_bwd.argtypes = ([ptr] * 10 + [int_] * 5
                                   + [f32, int_, int_, ptr])
    lib.group_norm_bwd.restype = int_
    return lib


def _on(device, kernel, reference):
    if device.type == "cuda":
        return kernel
    if device.type != "cpu":
        raise ValueError(f"no group norm kernel for device {device}")
    return reference


def group_norm_fwd(x3, gamma, beta, *, groups: int, eps: float = 1e-6,
                   relu: bool = False):
    """``(y, mean, inv)`` on ``[B, HW, C]``: the forward kernel for CUDA
    tensors, its plain version for CPU tensors."""
    _check(x3, gamma, beta, groups)
    fn = _on(x3.device, _fwd_kernel, group_norm_fwd_reference)
    return fn(x3, gamma, beta, groups=int(groups), eps=float(eps),
              relu=bool(relu))


def group_norm_bwd(x3, dy3, gamma, beta, mean, inv, *, groups: int,
                   relu: bool = False):
    """``(dx, dgamma_b, dbeta_b)`` on ``[B, HW, C]``: the backward kernel
    for CUDA tensors, its plain version for CPU tensors."""
    _check(x3, gamma, beta, groups)
    fn = _on(x3.device, _bwd_kernel, group_norm_bwd_reference)
    return fn(x3, dy3, gamma, beta, mean, inv, groups=int(groups),
              relu=bool(relu))


def _rows(x):
    """``[B, C, *spatial]`` -> its ``[B, HW, C]`` buffer: a view when the
    memory is channels-last; on a CUDA tensor anything else raises."""
    xl = x.movedim(1, -1)
    if x.device.type == "cuda" and not xl.is_contiguous():
        raise ValueError(
            "group_norm on CUDA needs channels-last memory "
            "(x.movedim(1, -1) contiguous, e.g. torch.channels_last); "
            f"got strides {x.stride()} for shape {tuple(x.shape)}")
    return xl.reshape(x.shape[0], -1, x.shape[1])


class _GroupNorm(torch.autograd.Function):
    """``x [B, C, *spatial] -> y`` (same shape and memory layout) with the
    hand-written backward; saves ``x, gamma, beta, mean, inv`` as the
    JAX VJP does, and sums the per-image dgamma, dbeta over B."""

    @staticmethod
    def forward(ctx, x, gamma, beta, groups, eps, relu):
        x3 = _rows(x)
        y3, mean, inv = group_norm_fwd(x3, gamma, beta, groups=groups,
                                       eps=eps, relu=relu)
        ctx.save_for_backward(x3, gamma, beta, mean, inv)
        ctx.groups, ctx.relu, ctx.shape = groups, relu, x.movedim(1, -1).shape
        return y3.view(ctx.shape).movedim(-1, 1)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        global gradient_copies
        x3, gamma, beta, mean, inv = ctx.saved_tensors
        dyl = dy.movedim(1, -1)
        if not dyl.is_contiguous() or dyl.dtype != x3.dtype:
            dyl = dyl.to(dtype=x3.dtype).contiguous()
            gradient_copies += 1
        dx3, dgamma_b, dbeta_b = group_norm_bwd(
            x3, dyl.view(x3.shape), gamma, beta, mean, inv,
            groups=ctx.groups, relu=ctx.relu)
        return (dx3.view(ctx.shape).movedim(-1, 1), dgamma_b.sum(0),
                dbeta_b.sum(0), None, None, None)


def group_norm(x, gamma, beta, *, groups: int, eps: float = 1e-6,
               relu: bool = False):
    """GroupNorm (+ ReLU) of ``x [B, C, *spatial]`` in channels-last
    memory, differentiable in ``x``, ``gamma`` and ``beta`` ([C] f32):
    the kernels for CUDA tensors, the plain versions for CPU tensors."""
    return _GroupNorm.apply(x, gamma, beta, int(groups), float(eps),
                            bool(relu))

