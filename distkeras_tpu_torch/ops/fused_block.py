"""The ResNet bottleneck's fused regions: the hand-written Hopper kernels
(``csrc/fused_block.cu``) and their plain PyTorch versions, each under
one ``torch.autograd.Function``.

Port of ``distkeras_tpu/ops/fused_block.py``:

``fused_conv1x1_gn``
    ``y = [relu](GN(x @ w))``: a 1x1 convolution (a matrix product over
    the ``[HW, Cin]`` rows of each image) with GroupNorm and an optional
    ReLU.  The bottleneck's first 1x1 conv and its downsample projection.
``fused_bottleneck_tail``
    ``out = relu(GN3(relu(GN2(y2)) @ w3) + residual)``: the 3x3 conv's
    GroupNorm, the second 1x1 conv, its GroupNorm, the residual add and
    the final ReLU.

The plain versions repeat the TPU kernels' own algebra and rounding
points (``_conv_gn_fwd_kernel``, ``_conv_gn_bwd_kernel``,
``_tail_fwd_kernel``, ``_tail_bwd_kernel``), not the JAX oracles':
statistics from the f32 product as E[y^2] - E[y]^2 clamped at 0,
``inv = rsqrt(var + eps)``; ``(y - mean) * inv * gamma + beta``; the
strict ``z > 0`` ReLU test recomputed in the backward; the tail's
``h`` rounded to the input dtype before its product; the backward's
raw-input gradient rounded to the input dtype before both of its
products; the weight gradient summed in f32 over every image.  The
backward recomputes the forward from the saved inputs, as the TPU
kernels do.

Layout contract.  The kernels read ``[B, HW, C]`` rows with channels
contiguous: the public functions take the model's ``[B, C, H, W]``
tensors in channels-last memory, whose ``movedim(1, -1)`` is that
buffer.  On a CUDA tensor any other layout raises; ``channels_last``
makes the one explicit copy a caller needs (the downsample's strided
input), counted in ``input_copies``.  An incoming gradient in another
layout is copied once, counted in ``gradient_copies``.

A CUDA tensor goes to the kernels or the call raises; a CPU tensor goes
to the plain versions.  ``conv_gn_fwd_launches``,
``conv_gn_bwd_launches``, ``tail_fwd_launches`` and
``tail_bwd_launches`` count calls of the four kernel entry points
(each launches several grids), and nothing else.

The bf16 kernels run every product on one tensor-core body
(``csrc/fused_gemm.cuh``: wgmma fed by TMA, the GroupNorm work in its
epilogue).  What bounds them is bytes: an f32 workspace of the product
written once and read again.  Each call's pass plan (``fwd_plan``,
``bwd_plan``) writes an f32 intermediate only where that takes less
time than recomputing it on the tensor cores from its bf16 input.  An
image's statistics need all of its rows before anything is applied, so
a forward is two passes with a fold between them: the second applies
the norm either to the kept f32 product (16-byte passes) or to the
product computed again with the apply in its epilogue
(``_fwd_store``).  The tail's backward keeps no ``[B*HW, C_out]`` f32
workspace, and ``conv_gn_bwd`` recomputes its product only where the
input is narrow (``_store_y``: on ResNet-50's path, the two calls that
read 64 channels).  f32 keeps the FMA products with an f32 workspace.
TMA and the 16-byte passes need 16-byte vectors of channels, so every
CUDA call takes channel counts that are multiples of 8.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch
from torch.autograd.function import once_differentiable

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: channels the kernels take at most (their shared-memory staging)
MAX_CHANNELS = 2048
#: elements of a statistics pass's row tile
TILE_ELEMS = 16384
#: rows of the weight gradient's chunks are a multiple of this (the
#: tensor-core products' depth step; the f32 chain's divides it)
K_STEP = 64
#: blocks the weight gradient's chunked product aims for (4 per SM)
DW_BLOCKS = 528
#: tile edge of the kernels' products
GEMM_TILE = 64
#: rows of a tensor-core product's tile (one wgmma M); a tile lies inside
#: one image
ROW_TILE = 64
#: operations the tensor-core products do in the time the card moves one
#: byte (about 330 TFLOP/s beside 3.35 TB/s): where #8's two plans, timed
#: at ResNet-50's 20 calls on an H100, trade places
PRODUCT_FLOPS_PER_BYTE = 100
#: the same for the forwards' one extra product (``_fwd_store``): where
#: their two plans, timed at the same calls, trade places (recomputing
#: won at 256 -> 128 over 3136 rows, which needs more than 128; keeping y
#: won at 512 -> 1024 over 196 rows and the 512 -> 2048 tail, which need
#: at most 146 and 136)
FWD_PRODUCT_FLOPS_PER_BYTE = 132
#: channels come in vectors of this many (16 bytes of bf16: TMA's row
#: stride and the passes' loads; 32 bytes of f32, two loads)
CHANNEL_STEP = 8

#: forward kernel launches of ``fused_conv1x1_gn`` since the last reset
conv_gn_fwd_launches = 0
#: its backward kernel launches
conv_gn_bwd_launches = 0
#: forward kernel launches of ``fused_bottleneck_tail``
tail_fwd_launches = 0
#: its backward kernel launches
tail_bwd_launches = 0
#: explicit channels-last copies of an input (``channels_last``)
input_copies = 0
#: explicit channels-last copies of an incoming gradient
gradient_copies = 0

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


# ---- plain versions --------------------------------------------------


def _per_channel(stat, c):
    """``[B, G]`` group statistic -> ``[B, 1, C]``."""
    return stat.repeat_interleave(c // stat.shape[-1], dim=-1)[:, None, :]


def _group_sum(s, groups):
    """``[B, C]`` channel sums -> ``[B, G]`` group sums."""
    return s.view(s.shape[0], groups, -1).sum(-1)


def _count(y, groups) -> float:
    return float(y.shape[1] * (y.shape[2] // groups))


def _gn_stats(y, groups, eps):
    """``_gn_stats``: per-channel ``(mean, inv)`` ``[B, 1, C]`` of the
    f32 ``y [B, HW, C]``."""
    c, count = y.shape[-1], _count(y, groups)
    g1 = _group_sum(y.sum(1), groups) / count
    g2 = _group_sum((y * y).sum(1), groups) / count
    inv = torch.rsqrt(torch.clamp(g2 - g1 * g1, min=0.0) + eps)
    return _per_channel(g1, c), _per_channel(inv, c)


def _gn_bwd(dz, xhat, gamma, inv_c, groups):
    """``_gn_bwd``: the gradient of the raw (pre-norm) tensor, and
    dgamma, dbeta summed over the images."""
    c, count = dz.shape[-1], _count(dz, groups)
    dgamma = (dz * xhat).sum(1).sum(0)
    dbeta = dz.sum(1).sum(0)
    dzg = dz * gamma
    t1 = _per_channel(_group_sum(dzg.sum(1), groups), c)
    t2 = _per_channel(_group_sum((dzg * xhat).sum(1), groups), c)
    return inv_c * (dzg - t1 / count - xhat * (t2 / count)), dgamma, dbeta


def _rows_sum(a, b):
    """``a^T @ b`` over every row of two ``[B, HW, *]`` tensors, f32."""
    return a.flatten(0, 1).float().T @ b.flatten(0, 1).float()


def conv1x1_gn_fwd_reference(x3, w, gamma, beta, *, groups: int,
                             eps: float = 1e-6, relu: bool = True):
    """Plain forward on ``x3 [B, HW, Cin]``, ``w [Cin, Cout]`` in x's
    dtype, ``gamma``/``beta`` ``[Cout]`` f32: ``y`` in x's dtype
    (``_conv_gn_fwd_kernel``)."""
    y = x3.float() @ w.float()
    mean, inv = _gn_stats(y, groups, eps)
    out = (y - mean) * inv * gamma + beta
    if relu:
        out = torch.clamp(out, min=0.0)
    return out.to(x3.dtype)


def conv1x1_gn_bwd_reference(x3, w, gamma, beta, dy3, *, groups: int,
                             eps: float = 1e-6, relu: bool = True):
    """Plain backward: ``(dx, dw, dgamma, dbeta)`` with ``dx`` in x's
    dtype and the rest f32, summed over the images
    (``_conv_gn_bwd_kernel``)."""
    y = x3.float() @ w.float()
    mean, inv = _gn_stats(y, groups, eps)
    xhat = (y - mean) * inv
    dz = dy3.float()
    if relu:
        dz = torch.where(xhat * gamma + beta > 0, dz, 0.0)
    dy_raw, dgamma, dbeta = _gn_bwd(dz, xhat, gamma, inv, groups)
    dy_b = dy_raw.to(x3.dtype)
    dx = (dy_b.float() @ w.float().T).to(x3.dtype)
    return dx, _rows_sum(x3, dy_b), dgamma, dbeta


def _tail_chain(y2, w, g2, b2, g3, b3, res, groups2, groups3, eps):
    """The tail's forward chain as both TPU kernels compute it."""
    mean2, inv2 = _gn_stats(y2.float(), groups2, eps)
    xhat2 = (y2.float() - mean2) * inv2
    u = xhat2 * g2 + b2
    hb = torch.clamp(u, min=0.0).to(y2.dtype)
    y3 = hb.float() @ w.float()
    mean3, inv3 = _gn_stats(y3, groups3, eps)
    xhat3 = (y3 - mean3) * inv3
    z = xhat3 * g3 + b3 + res.float()
    return xhat2, inv2, u, hb, xhat3, inv3, z


def bottleneck_tail_fwd_reference(y2, w, g2, b2, g3, b3, res, *,
                                  groups2: int, groups3: int,
                                  eps: float = 1e-6):
    """Plain forward on ``y2 [B, HW, Cm]``, ``w [Cm, Cout]``, ``res [B,
    HW, Cout]`` (all in y2's dtype) and four f32 rows: ``out`` in y2's
    dtype (``_tail_fwd_kernel``)."""
    z = _tail_chain(y2, w, g2, b2, g3, b3, res, groups2, groups3, eps)[-1]
    return torch.clamp(z, min=0.0).to(y2.dtype)


def bottleneck_tail_bwd_reference(y2, w, g2, b2, g3, b3, res, dout, *,
                                  groups2: int, groups3: int,
                                  eps: float = 1e-6):
    """Plain backward: ``(dy2, dw, dg2, db2, dg3, db3, dres)`` with
    ``dy2``, ``dres`` in the inputs' dtype and the rest f32, summed over
    the images (``_tail_bwd_kernel``)."""
    xhat2, inv2, u, hb, xhat3, inv3, z = _tail_chain(
        y2, w, g2, b2, g3, b3, res, groups2, groups3, eps)
    dz = torch.where(z > 0, dout.float(), 0.0)
    dy3, dg3, db3 = _gn_bwd(dz, xhat3, g3, inv3, groups3)
    dy3_b = dy3.to(y2.dtype)
    dh = torch.where(u > 0, dy3_b.float() @ w.float().T, 0.0)
    dy2, dg2, db2 = _gn_bwd(dh, xhat2, g2, inv2, groups2)
    return (dy2.to(y2.dtype), _rows_sum(hb, dy3_b), dg2, db2, dg3, db3,
            dz.to(res.dtype))


# ---- kernels ---------------------------------------------------------


def _check(rows, w, params, groups_by_width):
    """Shapes, dtypes and devices of one call: ``rows`` are the
    ``[B, HW, C]`` tensors (the first one sets the dtype), ``w`` is
    ``[C_in, C_out]`` in their dtype, ``params`` the f32 ``[C]`` rows,
    and each width's group count must divide it."""
    x3 = rows[0]
    if x3.dtype not in _DTYPES:
        raise TypeError(f"fused block takes {list(_DTYPES)}; got {x3.dtype}")
    for t in rows:
        if t.dim() != 3 or t.shape[:2] != x3.shape[:2] \
                or t.dtype != x3.dtype or t.device != x3.device:
            raise ValueError(f"[B, HW, C] inputs must agree in B, HW, dtype "
                             f"and device; got {tuple(t.shape)} {t.dtype} "
                             f"{t.device}")
    if w.dim() != 2 or w.dtype != x3.dtype or w.device != x3.device:
        raise ValueError(f"w must be [C_in, C_out] {x3.dtype} on "
                         f"{x3.device}; got {tuple(w.shape)} {w.dtype}")
    for p, c in params:
        if p.shape != (c,) or p.dtype != torch.float32 \
                or p.device != x3.device:
            raise ValueError(f"norm parameters must be [C]={c} f32 on "
                             f"{x3.device}; got {tuple(p.shape)} {p.dtype}")
    for c, g in groups_by_width:
        if c % g:
            raise ValueError(f"channels={c} not divisible by groups={g}")


def _check_kernel_inputs(*tensors):
    """Refuse what the kernels do not take: more than ``MAX_CHANNELS``,
    other than contiguous, or rows that are not whole 16-byte vectors of
    ``CHANNEL_STEP`` channels at 16-byte aligned addresses (TMA's rows,
    the passes' loads)."""
    for t in tensors:
        if t.shape[-1] > MAX_CHANNELS:
            raise ValueError(f"the CUDA kernels take at most {MAX_CHANNELS} "
                             f"channels; got {t.shape[-1]}")
        if not t.is_contiguous():
            raise ValueError("the CUDA kernels need contiguous [B, HW, C] "
                             "inputs (channels-last memory)")
        if t.shape[-1] % CHANNEL_STEP or t.data_ptr() % 16:
            raise ValueError(
                f"the CUDA kernels need channel counts that are multiples "
                f"of {CHANNEL_STEP} and 16-byte aligned rows (TMA, 16-byte "
                f"loads); got {t.shape[-1]} channels at address "
                f"{t.data_ptr():#x}")


def _rows_per_tile(hw: int, c: int) -> int:
    """Rows of a statistics pass's tile of an image with ``c`` channels
    (the kernels take the largest width of the call)."""
    return max(1, min(hw, TILE_ELEMS // c))


def _dw_chunks(m: int, k: int, n: int) -> tuple[int, int]:
    """``(chunks, rows per chunk)`` of the weight gradient's product
    ``[m, n]`` summed over ``k`` rows: enough chunks that ``DW_BLOCKS``
    blocks run, each a whole number of ``K_STEP`` rows."""
    tiles = -(-m // GEMM_TILE) * -(-n // GEMM_TILE)
    chunks = max(1, min(-(-DW_BLOCKS // tiles), -(-k // 512)))
    rows = -(-(-(-k // chunks)) // K_STEP) * K_STEP
    return -(-k // rows), rows


def _store_y(cin: int, cout: int) -> bool:
    """Whether #8's bf16 plan keeps the recomputed product ``y`` in f32
    between its passes: one f32 write and two reads (12 ``cout`` bytes a
    row) against computing it twice more from bf16 ``x``: two more reads
    (4 ``cin`` bytes a row) and two more products (4 ``cin cout``
    operations a row, at ``PRODUCT_FLOPS_PER_BYTE``)."""
    return 4 * cin + 4 * cin * cout / PRODUCT_FLOPS_PER_BYTE >= 12 * cout


def _fwd_store(cin: int, cout: int) -> bool:
    """Whether a bf16 forward keeps its product ``y = a @ w`` (``a``: #7's
    x, #9's h) in f32 between its two passes: one f32 write and one read
    (8 ``cout`` bytes a row) against computing it once more from bf16
    ``a``: one more read (2 ``cin`` bytes a row) and one more product (2
    ``cin cout`` operations a row, at ``FWD_PRODUCT_FLOPS_PER_BYTE``).
    Both plans move the rest alike (P1's read, the output, #9's
    residual)."""
    return 2 * cin + 2 * cin * cout / FWD_PRODUCT_FLOPS_PER_BYTE >= 8 * cout


def fwd_plan(kind: str, b: int, hw: int, cin: int, cout: int, groups,
             dtype, store: bool | None = None) -> dict:
    """The pass plan of one forward kernel call: ``kind`` "conv" (``cin``
    -> ``cout``, ``groups`` an int) or "tail" (``cin`` = C_m, ``groups``
    = (G2, G3)).  Returns ``store`` (the product kept in f32 for a
    16-byte apply pass, else recomputed with the apply in its epilogue),
    ``rows`` and ``tiles`` (the row tiles of the passes outside a
    product), ``row_tiles`` (the products' 64-row tiles of an image) and
    ``scratch``: ``(name, shape, dtype)`` of every buffer the kernel
    takes, in the C order.  f32 keeps the FMA product and its workspace;
    bf16 is the tensor-core plan (``csrc/fused_block.cu``:
    ``conv_gn_fwd_tc``, ``tail_fwd_tc``).  ``store`` overrides the rule
    for bf16 (to time both plans); None follows it."""
    f32 = torch.float32
    bf16 = dtype == torch.bfloat16
    row_tiles = -(-hw // ROW_TILE)
    store = (_fwd_store(cin, cout) if store is None else store) \
        if bf16 else True
    ws = ("ws", (b, hw, cout), f32) if store else None
    # the product's statistics: per 64-row tile in bf16 (its epilogue),
    # per R-row tile in f32 (a 16-byte pass)
    if kind == "conv":
        rows = _rows_per_tile(hw, cout)
        tiles = -(-hw // rows)
        scratch = [ws, ("part", (b, row_tiles if bf16 else tiles, 2, cout),
                        f32),
                   ("gstats", (b, groups, 4), f32)]
    elif kind == "tail":
        cm = cin
        g2, g3 = groups
        rows = _rows_per_tile(hw, max(cm, cout))
        tiles = -(-hw // rows)
        scratch = [("hb", (b, hw, cm), dtype), ws,
                   ("part2", (b, tiles, 2, cm), f32),
                   ("part3", (b, row_tiles if bf16 else tiles, 2, cout),
                    f32),
                   ("gstats2", (b, g2, 4), f32),
                   ("gstats3", (b, g3, 4), f32)]
    else:
        raise ValueError(f"kind must be 'conv' or 'tail'; got {kind!r}")
    return {"store": store, "rows": rows, "tiles": tiles,
            "row_tiles": row_tiles, "scratch": scratch}


def bwd_plan(kind: str, b: int, hw: int, cin: int, cout: int, groups,
             dtype, store: bool | None = None) -> dict:
    """The pass plan of one backward kernel call: ``kind`` "conv" (``cin``
    -> ``cout``, ``groups`` an int) or "tail" (``cin`` = C_m, ``groups``
    = (G2, G3)).  Returns ``store`` (``y`` kept in f32), ``rows`` and
    ``tiles`` (the row tiles of the passes outside a product),
    ``row_tiles`` (the products' 64-row tiles of an image), the weight
    gradient's ``chunks`` and ``kc`` rows each, and ``scratch``: ``(name,
    shape, dtype)`` of every buffer the kernel takes, in the C order.
    f32 keeps the FMA products and their workspaces; bf16 is the
    tensor-core plan (``csrc/fused_block.cu``: ``conv_gn_bwd_tc``,
    ``tail_bwd_tc``).
    ``store`` overrides the byte rule for a bf16 conv (to time both
    plans); None follows it."""
    f32 = torch.float32
    bf16 = dtype == torch.bfloat16
    m = b * hw
    chunks, kc = _dw_chunks(cin, m, cout)
    row_tiles = -(-hw // ROW_TILE)
    if kind == "conv":
        store = (_store_y(cin, cout) if store is None else store) \
            if bf16 else True
        rows = _rows_per_tile(hw, cout)
        tiles = -(-hw // rows)
        if bf16:
            grad_tiles = tiles if store else row_tiles
            scratch = [("ws", (b, hw, cout), f32) if store else None,
                       ("dyb", (b, hw, cout), dtype),
                       ("part", (b * (row_tiles + grad_tiles) * 2 * cout,),
                        f32),
                       ("per_image", (2, b, cout), f32),
                       ("dw_part", (chunks, cin, cout), f32),
                       ("gstats", (b, groups, 4), f32)]
        else:
            scratch = [("ws", (b, hw, cout), f32),
                       ("dyb", (b, hw, cout), dtype),
                       ("part", (2, b, tiles, 2, cout), f32),
                       ("per_image", (2, b, cout), f32),
                       ("dw_part", (chunks, cin, cout), f32),
                       ("gstats", (b, groups, 4), f32)]
    elif kind == "tail":
        if store is not None:
            raise ValueError("the tail has one plan; store must be None")
        cm = cin
        g2, g3 = groups
        store = False
        if bf16:
            rows = _rows_per_tile(hw, cm)
            tiles = -(-hw // rows)
            scratch = [("hb", (b, hw, cm), dtype), None,
                       ("dy3b", (b, hw, cout), dtype),
                       ("ws2", (b, hw, cm), f32),
                       ("part2", (b * (tiles + row_tiles) * 2 * cm,), f32),
                       ("part3", (2, b, row_tiles, 2, cout), f32),
                       ("per_image2", (2, b, cm), f32),
                       ("per_image3", (2, b, cout), f32),
                       ("dw_part", (chunks, cm, cout), f32),
                       ("gstats2", (b, g2, 4), f32),
                       ("gstats3", (b, g3, 4), f32)]
        else:
            rows = _rows_per_tile(hw, max(cm, cout))
            tiles = -(-hw // rows)
            scratch = [("hb", (b, hw, cm), dtype),
                       ("ws3", (b, hw, cout), f32),
                       ("dy3b", (b, hw, cout), dtype),
                       ("ws2", (b, hw, cm), f32),
                       ("part2", (2, b, tiles, 2, cm), f32),
                       ("part3", (2, b, tiles, 2, cout), f32),
                       ("per_image2", (2, b, cm), f32),
                       ("per_image3", (2, b, cout), f32),
                       ("dw_part", (chunks, cm, cout), f32),
                       ("gstats2", (b, g2, 4), f32),
                       ("gstats3", (b, g3, 4), f32)]
    else:
        raise ValueError(f"kind must be 'conv' or 'tail'; got {kind!r}")
    return {"store": store, "rows": rows, "tiles": tiles,
            "row_tiles": row_tiles, "chunks": chunks, "kc": kc,
            "scratch": scratch}


def _scratch(plan, device):
    """The plan's buffers, in the C order (None where the plan does
    without one); keep them alive until the launch is queued."""
    return [None if e is None else torch.empty(e[1], dtype=e[2],
                                               device=device)
            for e in plan["scratch"]]


def _ptrs(tensors):
    return [0 if t is None else t.data_ptr() for t in tensors]


def _launch(fn, name, device, *args):
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: error {err}")


def _f32(shape, device):
    return torch.empty(shape, dtype=torch.float32, device=device)


def _conv_gn_fwd_kernel(x3, w, gamma, beta, *, groups, eps, relu,
                        store=None):
    _check_kernel_inputs(x3, w, gamma, beta)
    b, hw, cin = x3.shape
    cout = w.shape[1]
    plan = fwd_plan("conv", b, hw, cin, cout, groups, x3.dtype, store)
    dev = x3.device
    y = torch.empty((b, hw, cout), dtype=x3.dtype, device=dev)
    scratch = _scratch(plan, dev)
    _launch(_library().conv_gn_fwd, "conv_gn_fwd", dev,
            x3.data_ptr(), w.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
            y.data_ptr(), *_ptrs(scratch), b, hw, cin, cout, groups,
            plan["rows"], int(plan["store"]), float(eps), int(relu),
            _DTYPES[x3.dtype])
    _note("conv_gn_fwd_launches")
    return y


def _conv_gn_bwd_kernel(x3, w, gamma, beta, dy3, *, groups, eps, relu,
                        store=None):
    _check_kernel_inputs(x3, w, gamma, beta, dy3)
    b, hw, cin = x3.shape
    cout = w.shape[1]
    plan = bwd_plan("conv", b, hw, cin, cout, groups, x3.dtype, store)
    dev = x3.device
    dx = torch.empty_like(x3)
    dw = _f32((cin, cout), dev)
    dgamma, dbeta = _f32((cout,), dev), _f32((cout,), dev)
    scratch = _scratch(plan, dev)
    _launch(_library().conv_gn_bwd, "conv_gn_bwd", dev,
            x3.data_ptr(), w.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
            dy3.data_ptr(), dx.data_ptr(), dw.data_ptr(), dgamma.data_ptr(),
            dbeta.data_ptr(), *_ptrs(scratch), b, hw, cin, cout, groups,
            plan["rows"], plan["chunks"], plan["kc"], int(plan["store"]),
            float(eps), int(relu), _DTYPES[x3.dtype])
    _note("conv_gn_bwd_launches")
    return dx, dw, dgamma, dbeta


def _tail_fwd_kernel(y2, w, g2, b2, g3, b3, res, *, groups2, groups3, eps,
                     store=None):
    _check_kernel_inputs(y2, w, g2, b2, g3, b3, res)
    b, hw, cm = y2.shape
    cout = w.shape[1]
    plan = fwd_plan("tail", b, hw, cm, cout, (groups2, groups3), y2.dtype,
                    store)
    dev = y2.device
    out = torch.empty_like(res)
    scratch = _scratch(plan, dev)
    _launch(_library().tail_fwd, "tail_fwd", dev,
            y2.data_ptr(), w.data_ptr(), g2.data_ptr(), b2.data_ptr(),
            g3.data_ptr(), b3.data_ptr(), res.data_ptr(), out.data_ptr(),
            *_ptrs(scratch), b, hw, cm, cout, groups2, groups3, plan["rows"],
            int(plan["store"]), float(eps), _DTYPES[y2.dtype])
    _note("tail_fwd_launches")
    return out


def _tail_bwd_kernel(y2, w, g2, b2, g3, b3, res, dout, *, groups2, groups3,
                     eps):
    _check_kernel_inputs(y2, w, g2, b2, g3, b3, res, dout)
    b, hw, cm = y2.shape
    cout = w.shape[1]
    plan = bwd_plan("tail", b, hw, cm, cout, (groups2, groups3), y2.dtype)
    dev = y2.device
    dy2, dres = torch.empty_like(y2), torch.empty_like(res)
    dw = _f32((cm, cout), dev)
    dg2, db2 = _f32((cm,), dev), _f32((cm,), dev)
    dg3, db3 = _f32((cout,), dev), _f32((cout,), dev)
    scratch = _scratch(plan, dev)
    _launch(_library().tail_bwd, "tail_bwd", dev,
            y2.data_ptr(), w.data_ptr(), g2.data_ptr(), b2.data_ptr(),
            g3.data_ptr(), b3.data_ptr(), res.data_ptr(), dout.data_ptr(),
            dy2.data_ptr(), dw.data_ptr(), dg2.data_ptr(), db2.data_ptr(),
            dg3.data_ptr(), db3.data_ptr(), dres.data_ptr(), *_ptrs(scratch),
            b, hw, cm, cout, groups2, groups3, plan["rows"], plan["chunks"],
            plan["kc"], float(eps), _DTYPES[y2.dtype])
    _note("tail_bwd_launches")
    return dy2, dw, dg2, db2, dg3, db3, dres


@functools.lru_cache(maxsize=None)
def _library():
    from distkeras_tpu_torch.ops import _build

    ptr, int_, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib = _build.load("fused_block")
    signatures = {
        "conv_gn_fwd": [ptr] * 8 + [int_] * 7 + [f32, int_, int_, ptr],
        "conv_gn_bwd": [ptr] * 15 + [int_] * 9 + [f32, int_, int_, ptr],
        "tail_fwd": [ptr] * 14 + [int_] * 8 + [f32, int_, ptr],
        "tail_bwd": [ptr] * 26 + [int_] * 9 + [f32, int_, ptr],
    }
    for name, args in signatures.items():
        getattr(lib, name).argtypes = args
        getattr(lib, name).restype = int_
    return lib


def _on(device, kernel, reference):
    if device.type == "cuda":
        return kernel
    if device.type != "cpu":
        raise ValueError(f"no fused block kernel for device {device}")
    return reference


# ---- entry points on [B, HW, C] ---------------------------------------


def conv1x1_gn_fwd(x3, w, gamma, beta, *, groups: int, eps: float = 1e-6,
                   relu: bool = True):
    """``y [B, HW, Cout]``: the forward kernel for CUDA tensors, its plain
    version for CPU tensors."""
    _check([x3], w, [(gamma, w.shape[1]), (beta, w.shape[1])],
           [(w.shape[1], groups)])
    if x3.shape[-1] != w.shape[0]:
        raise ValueError(f"x has {x3.shape[-1]} channels, w takes "
                         f"{w.shape[0]}")
    fn = _on(x3.device, _conv_gn_fwd_kernel, conv1x1_gn_fwd_reference)
    return fn(x3, w, gamma, beta, groups=int(groups), eps=float(eps),
              relu=bool(relu))


def conv1x1_gn_bwd(x3, w, gamma, beta, dy3, *, groups: int,
                   eps: float = 1e-6, relu: bool = True):
    """``(dx, dw, dgamma, dbeta)``, ``dw`` and the rows f32: the backward
    kernel for CUDA tensors, its plain version for CPU tensors."""
    _check([x3], w, [(gamma, w.shape[1]), (beta, w.shape[1])],
           [(w.shape[1], groups)])
    _check([x3, dy3], w, [], [])
    if dy3.shape[-1] != w.shape[1]:
        raise ValueError(f"dy has {dy3.shape[-1]} channels, w gives "
                         f"{w.shape[1]}")
    fn = _on(x3.device, _conv_gn_bwd_kernel, conv1x1_gn_bwd_reference)
    return fn(x3, w, gamma, beta, dy3, groups=int(groups), eps=float(eps),
              relu=bool(relu))


def _tail_checks(y2, w, g2, b2, g3, b3, res, groups2, groups3):
    cm, cout = w.shape
    _check([y2], w, [(g2, cm), (b2, cm), (g3, cout), (b3, cout)],
           [(cm, groups2), (cout, groups3)])
    _check([y2, res], w, [], [])
    if y2.shape[-1] != cm or res.shape[-1] != cout:
        raise ValueError(f"y2 [.., {y2.shape[-1]}] and residual "
                         f"[.., {res.shape[-1]}] do not fit w {cm}x{cout}")


def bottleneck_tail_fwd(y2, w, g2, b2, g3, b3, res, *, groups2: int,
                        groups3: int, eps: float = 1e-6):
    """``out [B, HW, Cout]``: the forward kernel for CUDA tensors, its
    plain version for CPU tensors."""
    _tail_checks(y2, w, g2, b2, g3, b3, res, groups2, groups3)
    fn = _on(y2.device, _tail_fwd_kernel, bottleneck_tail_fwd_reference)
    return fn(y2, w, g2, b2, g3, b3, res, groups2=int(groups2),
              groups3=int(groups3), eps=float(eps))


def bottleneck_tail_bwd(y2, w, g2, b2, g3, b3, res, dout, *, groups2: int,
                        groups3: int, eps: float = 1e-6):
    """``(dy2, dw, dg2, db2, dg3, db3, dres)``: the backward kernel for
    CUDA tensors, its plain version for CPU tensors."""
    _tail_checks(y2, w, g2, b2, g3, b3, res, groups2, groups3)
    _check([res, dout], w, [], [])
    if dout.shape != res.shape:
        raise ValueError(f"dout {tuple(dout.shape)} must match the "
                         f"residual {tuple(res.shape)}")
    fn = _on(y2.device, _tail_bwd_kernel, bottleneck_tail_bwd_reference)
    return fn(y2, w, g2, b2, g3, b3, res, dout, groups2=int(groups2),
              groups3=int(groups3), eps=float(eps))


# ---- the model's functions on [B, C, H, W] ----------------------------


def channels_last(x):
    """``x [B, C, H, W]`` with channels-last memory: itself where it has
    that layout, else one explicit copy, counted in ``input_copies``."""
    if x.movedim(1, -1).is_contiguous():
        return x
    _note("input_copies")
    return x.contiguous(memory_format=torch.channels_last)


def _rows(x):
    """``[B, C, H, W]`` -> its ``[B, HW, C]`` buffer: a view when the
    memory is channels-last; on a CUDA tensor anything else raises."""
    xl = x.movedim(1, -1)
    if x.device.type == "cuda" and not xl.is_contiguous():
        raise ValueError(
            "the fused block on CUDA needs channels-last memory "
            "(x.movedim(1, -1) contiguous; see channels_last); got "
            f"strides {x.stride()} for shape {tuple(x.shape)}")
    return xl.reshape(x.shape[0], -1, x.shape[1])


def _grad_rows(dy, dtype):
    """An incoming gradient ``[B, C, H, W]`` as ``[B, HW, C]`` rows of
    ``dtype``, copied once (counted in ``gradient_copies``) where its
    layout or dtype differ."""
    dyl = dy.movedim(1, -1)
    if not dyl.is_contiguous() or dyl.dtype != dtype:
        dyl = dyl.to(dtype=dtype).contiguous()
        _note("gradient_copies")
    return dyl.reshape(dy.shape[0], -1, dy.shape[1])


def _image(rows3, shape):
    """``[B, HW, C]`` rows -> ``[B, C, H, W]`` channels-last view."""
    return rows3.view(shape).movedim(-1, 1)


class _ConvGN(torch.autograd.Function):
    """``x [B, Cin, H, W] -> y [B, Cout, H, W]`` (channels-last) with the
    hand-written backward; saves the inputs, as the JAX VJP does."""

    @staticmethod
    def forward(ctx, x, w, gamma, beta, groups, eps, relu):
        x3 = _rows(x)
        y3 = conv1x1_gn_fwd(x3, w, gamma, beta, groups=groups, eps=eps,
                            relu=relu)
        ctx.save_for_backward(x3, w, gamma, beta)
        ctx.args = (groups, eps, relu)
        ctx.xshape = x.movedim(1, -1).shape
        return _image(y3, (*ctx.xshape[:-1], w.shape[1]))

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x3, w, gamma, beta = ctx.saved_tensors
        groups, eps, relu = ctx.args
        dy3 = _grad_rows(dy, x3.dtype)
        dx3, dw, dgamma, dbeta = conv1x1_gn_bwd(
            x3, w, gamma, beta, dy3, groups=groups, eps=eps, relu=relu)
        return (_image(dx3, ctx.xshape), dw.to(w.dtype), dgamma, dbeta,
                None, None, None)


class _Tail(torch.autograd.Function):
    """``(y2, residual) -> out`` (channels-last ``[B, C, H, W]``) with the
    hand-written backward, differentiable in every tensor argument."""

    @staticmethod
    def forward(ctx, y2, w, g2, b2, g3, b3, res, groups2, groups3, eps):
        y23, res3 = _rows(y2), _rows(res)
        out3 = bottleneck_tail_fwd(y23, w, g2, b2, g3, b3, res3,
                                   groups2=groups2, groups3=groups3, eps=eps)
        ctx.save_for_backward(y23, w, g2, b2, g3, b3, res3)
        ctx.args = (groups2, groups3, eps)
        ctx.shapes = (y2.movedim(1, -1).shape, res.movedim(1, -1).shape)
        return _image(out3, ctx.shapes[1])

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        y23, w, g2, b2, g3, b3, res3 = ctx.saved_tensors
        groups2, groups3, eps = ctx.args
        dy2, dw, dg2, db2, dg3, db3, dres = bottleneck_tail_bwd(
            y23, w, g2, b2, g3, b3, res3, _grad_rows(dout, res3.dtype),
            groups2=groups2, groups3=groups3, eps=eps)
        return (_image(dy2, ctx.shapes[0]), dw.to(w.dtype), dg2, db2, dg3,
                db3, _image(dres, ctx.shapes[1]), None, None, None)


def fused_conv1x1_gn(x, w, gamma, beta, *, groups: int, eps: float = 1e-6,
                     relu: bool = True):
    """1x1 conv + GroupNorm (+ ReLU) of ``x [B, Cin, H, W]`` in
    channels-last memory; ``w [Cin, Cout]`` in x's dtype, ``gamma``,
    ``beta`` ``[Cout]`` f32; differentiable in all four."""
    return _ConvGN.apply(x, w, gamma, beta, int(groups), float(eps),
                         bool(relu))


def fused_bottleneck_tail(y2, w, gamma2, beta2, gamma3, beta3, residual, *,
                          groups2: int, groups3: int, eps: float = 1e-6):
    """``relu(GN3(relu(GN2(y2)) @ w) + residual)`` of ``y2 [B, Cm, H,
    W]`` and ``residual [B, Cout, H, W]`` in channels-last memory, ``w
    [Cm, Cout]`` in their dtype and four f32 rows; differentiable in
    every tensor argument."""
    return _Tail.apply(y2, w, gamma2, beta2, gamma3, beta3, residual,
                       int(groups2), int(groups3), float(eps))
