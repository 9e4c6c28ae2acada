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
entry points, and nothing else; ``route_launches`` counts the same
calls by direction and route.

Routes.  ``gn_plan`` chooses, from the shape, the dtype and the card's
cluster capacity (which ``launch_plan`` asks the card for) before any
launch, how a call runs: the one-pass route (one launch: each image, or each channel
split of whole groups, held on chip by a thread-block cluster of ``k``
blocks, each input read once, partials exchanged through distributed
shared memory) wherever clusters can hold the image, else the two-pass
route (a statistics grid, a fold once per image, an apply grid).  A
launch that fails raises; nothing gives way to the other route or to
the plain version.
"""

from __future__ import annotations

import ctypes
import functools
import threading
import math
from typing import NamedTuple

import torch
from torch.autograd.function import once_differentiable

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: channels the kernels take at most (their shared-memory staging)
MAX_CHANNELS = 4096
#: elements of a two-pass block's row tile
TILE_ELEMS = 16384
#: threads a block of every GroupNorm kernel runs (``NT`` in the source)
THREADS = 256
#: fewest bytes of a row a channel split holds (splits of 32 bytes read
#: slower)
MIN_SPLIT_BYTES = 64
#: shared memory one block may use on sm_90 (bytes)
SMEM_PER_BLOCK = 232_448
#: blocks a wave of one-pass clusters aims at, about one an SM: among
#: the launches with the fewest waves the plan takes the one nearest it,
#: then the smallest cluster (an exchange costs more with k) and the
#: fewest splits, as a sweep of every launch ranked them at ResNet-50's
#: shapes on an H100
WAVE_BLOCKS = 128
#: largest cluster the source launches (``KMAX``), the portable limit:
#: channel splits keep every path image within it
KMAX = 8
ROUTES = ("one_pass", "two_pass")

#: forward kernel launches since the last reset (``fwd_launches = 0``)
fwd_launches = 0
#: backward kernel launches since the last reset
bwd_launches = 0
#: the same calls by direction and route (reset each value to 0)
route_launches = {f"{d}_{r}": 0 for d in ("fwd", "bwd") for r in ROUTES}
#: explicit channels-last copies of an incoming gradient
gradient_copies = 0

#: guards the counters: worker threads launch kernels concurrently, and a
#: bare ``+= 1`` on a module global can lose counts between threads
_count_lock = threading.Lock()


def _note(*counters: str) -> None:
    """Add one to each named counter of this module (``fwd_launches``,
    ``bwd_launches``, ``gradient_copies``) or key of ``route_launches``,
    under ``_count_lock``."""
    g = globals()
    with _count_lock:
        for name in counters:
            if name in g:
                g[name] += 1
            else:
                g["route_launches"][name] += 1


class Plan(NamedTuple):
    """How one kernel call runs: ``route`` (``"one_pass"`` or
    ``"two_pass"``); ``k`` blocks a cluster (0 on the two-pass route);
    ``rows`` per block (one-pass) or per tile (two-pass); ``smem`` bytes
    of dynamic shared memory a one-pass block takes (0 on the two-pass
    route); ``scratch`` f32 elements of the two-pass route's partials;
    ``splits`` channel splits of an image, each its own cluster (1 on
    the two-pass route)."""
    route: str
    k: int
    rows: int
    smem: int
    scratch: int
    splits: int = 1


def _item(dtype) -> int:
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype, None)
    if dtype not in _DTYPES:
        raise TypeError(f"group norm takes {list(_DTYPES)}; got {dtype}")
    return dtype.itemsize


def _cluster_smem(rows, c, g, item, inputs, k):
    """A one-pass block's shared memory (``cluster_smem`` in the source)
    for ``rows`` rows of a split's ``c`` channels and ``g`` groups: its
    rows of each input, each padded to 128 bytes; the row lanes' fold
    buffer ``[2][E-1][CVc*V]`` f32 (``Lanes``: E row lanes are left once
    those in one warp fold by shuffles); the statistics and the inboxes
    the cluster's ``k`` blocks write into (f32)."""
    v = 16 // item
    cvc = min(c // v, THREADS)
    lanes = THREADS // cvc
    if cvc < 32 and cvc & (cvc - 1) == 0:
        lanes //= 32 // cvc
    held = -(-rows * c * item // 128) * 128
    stats = (2 * c + 2 * g + 2 * k * g if inputs == 1
             else 2 * c + 2 * g + 2 * k * g + 2 * k * -(-c // k))
    return inputs * held + 4 * 2 * (lanes - 1) * cvc * v + 4 * stats


def gn_plan(b, hw, c, g, dtype, direction, *, capacity, aligned=True,
            route=None, k=None, splits=None):
    """The route of one GroupNorm kernel call on ``[b, hw, c]`` with ``g``
    groups, ``direction`` ``"fwd"`` or ``"bwd"``, chosen by shape before
    launch.  ``capacity(k, splits, rows, smem)`` gives how many clusters
    of such a launch the card holds at once (``launch_plan`` asks the
    card; 0 where it cannot schedule them).

    One-pass where 16-byte vectors take the rows (``c`` a multiple of 16
    bytes, every tensor 16-byte ``aligned``) and clusters can hold the
    image: each image is cut into ``splits`` channel splits of whole
    groups (at least ``MIN_SPLIT_BYTES`` of a row), each split's rows
    over a cluster of ``k`` blocks (a power of two up to ``KMAX``), each
    block holding its ``ceil(hw / k)`` rows of every input within
    ``SMEM_PER_BLOCK``.  Among those launches the card can schedule the
    plan takes one with the fewest waves of clusters
    (``ceil(b * splits / capacity)``): the one whose waves come nearest
    ``WAVE_BLOCKS`` blocks, then the smallest k, then the fewest splits.
    Else two-pass, over row tiles of about ``TILE_ELEMS`` elements.
    ``route`` forces a route, ``k`` and ``splits`` a launch (taken as
    given, without asking ``capacity``; a one-pass launch the shape
    cannot take raises).  Raises ``ValueError`` on a shape the kernels
    do not take."""
    item = _item(dtype)
    if direction not in ("fwd", "bwd"):
        raise ValueError(f"direction must be 'fwd' or 'bwd'; got "
                         f"{direction!r}")
    if route not in (None, *ROUTES):
        raise ValueError(f"route must be one of {ROUTES}; got {route!r}")
    if min(b, hw, c, g) < 1:
        raise ValueError(f"group norm needs a non-empty [B, HW, C] and "
                         f"groups; got [{b}, {hw}, {c}], groups={g}")
    if c % g:
        raise ValueError(f"channels={c} not divisible by groups={g}")
    if c > MAX_CHANNELS:
        raise ValueError(f"the CUDA kernels take at most {MAX_CHANNELS} "
                         f"channels; got {c}")
    forced = k is not None or splits is not None
    if capacity is None and not forced and route != "two_pass":
        raise TypeError("an unforced plan needs the card's capacity")
    if forced and (route == "two_pass" or not 1 <= (k or 1) <= KMAX
                   or (splits or 1) < 1):
        raise ValueError(f"no one-pass launch with a cluster of {k} "
                         f"over {splits} splits (route={route!r})")
    inputs = 1 if direction == "fwd" else 2
    if route != "two_pass" and aligned and (c * item) % 16 == 0:
        launches = ([(splits or 1, k or 1)] if forced else
                    [(s, n) for s in (1, 2, 4, 8, 16)
                     for n in (1, 2, 4, 8)])
        fits = []  # (waves, distance from WAVE_BLOCKS, k, splits), plan
        for s, n in launches:
            cl = c // s
            if (c % s or g % s or cl * item % 16
                    or s > 1 and cl * item < MIN_SPLIT_BYTES):
                continue
            rows = -(-hw // n)
            smem = _cluster_smem(rows, cl, g // s, item, inputs, n)
            if smem > SMEM_PER_BLOCK:
                continue
            plan = Plan("one_pass", n, rows, smem, 0, s)
            if forced:
                return plan
            at_once = capacity(n, s, rows, smem)
            if at_once > 0:
                waves = -(-b * s // at_once)
                near = abs(math.log2(b * s * n / waves / WAVE_BLOCKS))
                fits.append(((waves, near, n, s), plan))
        if fits:
            return min(fits)[1]
    if route == "one_pass" or forced:
        raise ValueError(
            f"the one-pass route cannot take {direction} [{b}, {hw}, {c}] "
            f"{dtype} (aligned={aligned}, k={k}, splits={splits}): no "
            f"launch of clusters of at most {k or KMAX} blocks the card "
            f"can schedule holds the image")
    rows = max(1, min(hw, TILE_ELEMS // c))
    tiles = -(-hw // rows)
    scratch = (b * tiles * 2 * g if direction == "fwd"
               else b * tiles * 2 * c + b * 2 * g)
    return Plan("two_pass", 0, rows, 0, scratch)


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


def _aligned(*tensors):
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _launch(fn, name, device, *args):
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: error {err}")


def _fwd_kernel(x3, gamma, beta, *, groups: int, eps: float, relu: bool,
                route=None, k=None, splits=None):
    """The forward kernel on the route ``launch_plan`` chooses
    (``route``, ``k`` and ``splits`` force one)."""
    _check_kernel_inputs(x3, gamma, beta)
    b, hw, c = x3.shape
    dev = x3.device
    y = torch.empty_like(x3)
    plan = launch_plan(b, hw, c, groups, x3.dtype, "fwd", dev,
                       aligned=_aligned(x3, y), route=route, k=k,
                       splits=splits)
    mean = torch.empty((b, groups), dtype=torch.float32, device=dev)
    inv = torch.empty_like(mean)
    part = torch.empty(plan.scratch, dtype=torch.float32, device=dev)
    _launch(_library().group_norm_fwd, "group_norm_fwd", dev,
            x3.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
            mean.data_ptr(), inv.data_ptr(), part.data_ptr(), b, hw, c,
            groups, plan.rows, plan.k, plan.splits, _count(x3, groups),
            float(eps), int(relu), _DTYPES[x3.dtype])
    _note("fwd_launches", f"fwd_{plan.route}")
    return y, mean, inv


def _bwd_kernel(x3, dy3, gamma, beta, mean, inv, *, groups: int,
                relu: bool, route=None, k=None, splits=None):
    """The backward kernel on the route ``launch_plan`` chooses
    (``route``, ``k`` and ``splits`` force one)."""
    _check_kernel_inputs(x3, dy3, gamma, beta, mean, inv)
    if dy3.shape != x3.shape or dy3.dtype != x3.dtype:
        raise ValueError("dy must match x in shape and dtype")
    b, hw, c = x3.shape
    if mean.shape != (b, groups) or inv.shape != (b, groups):
        raise ValueError(f"mean and inv must be [B, G]=[{b}, {groups}]")
    dev = x3.device
    dx = torch.empty_like(x3)
    plan = launch_plan(b, hw, c, groups, x3.dtype, "bwd", dev,
                       aligned=_aligned(x3, dy3, dx), route=route, k=k,
                       splits=splits)
    dgamma_b = torch.empty((b, c), dtype=torch.float32, device=dev)
    dbeta_b = torch.empty_like(dgamma_b)
    part = torch.empty(plan.scratch, dtype=torch.float32, device=dev)
    _launch(_library().group_norm_bwd, "group_norm_bwd", dev,
            x3.data_ptr(), dy3.data_ptr(), gamma.data_ptr(),
            beta.data_ptr(), mean.data_ptr(), inv.data_ptr(),
            dx.data_ptr(), dgamma_b.data_ptr(), dbeta_b.data_ptr(),
            part.data_ptr(), b, hw, c, groups, plan.rows, plan.k,
            plan.splits, _count(x3, groups), int(relu), _DTYPES[x3.dtype])
    _note("bwd_launches", f"bwd_{plan.route}")
    return dx, dgamma_b, dbeta_b


def launch_plan(b, hw, c, g, dtype, direction, device, *, aligned=True,
                route=None, k=None, splits=None):
    """``gn_plan`` with the card's capacity: the plan a CUDA call on
    ``device`` launches (``cudaOccupancyMaxActiveClusters`` of each
    cluster size), worked out once per shape."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return _launch_plan(b, hw, c, g, dtype, direction, device, aligned,
                        route, k, splits)


@functools.lru_cache(maxsize=None)
def _launch_plan(b, hw, c, g, dtype, direction, device, aligned, route, k,
                 splits):
    def capacity(size, cuts, rows, smem):
        with torch.cuda.device(device):
            return _max_clusters(b, hw, c, g, dtype, direction, rows, size,
                                 cuts)

    return gn_plan(b, hw, c, g, dtype, direction, capacity=capacity,
                   aligned=aligned, route=route, k=k, splits=splits)


def _max_clusters(b, hw, c, g, dtype, direction, rows, k, splits):
    """``cudaOccupancyMaxActiveClusters`` of a one-pass launch on the
    current device: how many of its clusters the card holds at once."""
    out = ctypes.c_int(-1)
    err = _library().group_norm_max_clusters(
        int(direction == "bwd"), _DTYPES[dtype], b, hw, c, g, rows, k,
        splits, ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed: "
                           f"error {err}")
    return out.value


def one_pass_launch(plan, b, hw, c, g, dtype, direction):
    """What the card makes of a one-pass ``plan``: ``(shared memory a
    block is launched with, clusters the card holds at once)``, from the
    kernel source (``group_norm_smem``) and
    ``cudaOccupancyMaxActiveClusters``."""
    smem = _library().group_norm_smem(int(direction == "bwd"),
                                      _DTYPES[dtype], b, hw, c, g,
                                      plan.rows, plan.k, plan.splits)
    return smem, _max_clusters(b, hw, c, g, dtype, direction, plan.rows,
                               plan.k, plan.splits)


@functools.lru_cache(maxsize=None)
def _library():
    from distkeras_tpu_torch.ops import _build

    ptr, int_, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib = _build.load("group_norm")
    lib.group_norm_fwd.argtypes = ([ptr] * 7 + [int_] * 7
                                   + [f32, f32, int_, int_, ptr])
    lib.group_norm_fwd.restype = int_
    lib.group_norm_bwd.argtypes = ([ptr] * 10 + [int_] * 7
                                   + [f32, int_, int_, ptr])
    lib.group_norm_bwd.restype = int_
    lib.group_norm_smem.argtypes = [int_] * 9
    lib.group_norm_smem.restype = ctypes.c_longlong
    lib.group_norm_max_clusters.argtypes = [int_] * 9 + [
        ctypes.POINTER(int_)]
    lib.group_norm_max_clusters.restype = int_
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
        x3, gamma, beta, mean, inv = ctx.saved_tensors
        dyl = dy.movedim(1, -1)
        if not dyl.is_contiguous() or dyl.dtype != x3.dtype:
            dyl = dyl.to(dtype=x3.dtype).contiguous()
            _note("gradient_copies")
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

