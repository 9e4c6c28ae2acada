"""ResNet family of the ImageNet baseline config, the port of
``distkeras_tpu/models/resnet.py``.

The same configurations: basic and bottleneck blocks, stems ``conv``
(7x7/s2) and ``space_to_depth`` (the exact 4x4/s1 re-layout of the 7x7/s2
stem over a 2x2 phase fold), norms ``group`` (``F.group_norm``),
``group_pallas`` (the hand-written GroupNorm kernels of
``ops/group_norm.py``), ``batch`` (flax's ``nn.BatchNorm``) and
``none``; bf16 compute with f32 parameters;
``fusion="pallas_block"`` / ``"pallas_tail"`` (``fusion_stages``), the
bottleneck lowered through the fused-block kernels of
``ops/fused_block.py`` (``FusedBottleneckBlock``).
The model takes the JAX config's NHWC input and runs its activations as
channels-last ``[B, C, H, W]`` tensors (``layers.py``), the layout the
GroupNorm kernels read as ``[B, HW, C]`` without a copy.

Parameters keep flax's module names (``Conv_0``, ``AdaptiveGroupNorm_0``,
``BottleneckBlock_3``, ``Dense_0``, with ``GroupNorm_0`` nested under
``AdaptiveGroupNorm_i`` for ``norm="group"`` as flax nests it), so
``convert`` maps a JAX tree leaf by leaf.  A norm module is named by the
class ``_norm`` builds, as flax names it: ``norm="batch"`` gives
``_BatchNormRelu_i/BatchNorm_0/{scale,bias}`` and the running
statistics ``{mean,var}`` as buffers (flax's ``batch_stats``).  flax
numbers the blocks per class, so ``fusion_stages=(0, 1)`` gives
``FusedBottleneckBlock_0..6`` then ``BottleneckBlock_0..8``.

``forward(x, train=False)`` takes flax's mode: in train mode BatchNorm
normalizes by the batch's statistics and updates its running ones (see
``_BatchNorm``), in eval mode it reads the running ones; the other norms
ignore the mode.
"""

from __future__ import annotations

import functools
import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from distkeras_tpu_torch.models.core import register_model
from distkeras_tpu_torch.models.layers import (Conv, Dense, FlaxInit,
                                               compute_dtype, max_pool_same)
from distkeras_tpu_torch.ops import fused_block
from distkeras_tpu_torch.ops.group_norm import group_norm


class _GroupNormParams(nn.Module):
    """flax ``nn.GroupNorm``'s parameters (``scale``, ``bias``)."""

    def __init__(self, channels: int, zero_scale: bool):
        super().__init__()
        self.zero_scale = zero_scale
        self.scale = nn.Parameter(torch.empty(channels))
        self.bias = nn.Parameter(torch.empty(channels))


class AdaptiveGroupNorm(nn.Module):
    """GroupNorm with ``gcd(32, channels)`` groups, eps 1e-6, and an
    optional fused ReLU.  ``impl="flax"`` is ``F.group_norm`` in f32
    (parameters under ``GroupNorm_0``, as flax's ``nn.GroupNorm`` nests
    them);
    ``impl="pallas"`` is the GroupNorm kernels (parameters directly
    here, as the JAX package's Pallas spelling holds them)."""

    def __init__(self, channels: int, relu: bool = False,
                 impl: str = "flax", zero_scale: bool = False):
        super().__init__()
        if impl not in ("flax", "pallas"):
            raise ValueError(f"unknown AdaptiveGroupNorm impl {impl!r}")
        self.groups = math.gcd(32, channels)
        self.relu, self.impl, self.zero_scale = relu, impl, zero_scale
        if impl == "flax":
            self.GroupNorm_0 = _GroupNormParams(channels, zero_scale)
        else:
            self.scale = nn.Parameter(torch.empty(channels))
            self.bias = nn.Parameter(torch.empty(channels))

    def forward(self, x, train: bool = False):
        if self.impl == "pallas":
            return group_norm(x, self.scale, self.bias, groups=self.groups,
                              relu=self.relu)
        # in f32 with f32 scale and bias, rounded once to x's dtype, as
        # flax's nn.GroupNorm computes (F.group_norm on bf16 would take
        # the scale in bf16 and round differently)
        p = self.GroupNorm_0
        y = F.group_norm(x.float(), self.groups, p.scale, p.bias, eps=1e-6)
        return (F.relu(y) if self.relu else y).to(x.dtype)


class _Identity(nn.Module):
    """No-op norm (``norm="none"``)."""

    def __init__(self, channels: int, relu: bool = False,
                 zero_scale: bool = False):
        super().__init__()
        self.relu = relu

    def forward(self, x, train: bool = False):
        return F.relu(x) if self.relu else x


class _BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over the
    channels of a ``[B, C, H, W]`` tensor: parameters ``scale`` and
    ``bias``, running statistics ``mean`` and ``var`` (f32 buffers in
    every compute dtype; no ``num_batches_tracked``, which flax lacks).

    flax's arithmetic, not ``nn.BatchNorm2d``'s: the batch statistics
    are taken in f32, the variance biased (``E[x^2] - E[x]^2`` clamped
    at 0, flax's ``use_fast_variance``), the running update ``0.9 *
    running + 0.1 * batch`` (torch would use the unbiased variance), and
    ``y = (x - mean) * (rsqrt(var + eps) * scale) + bias`` in f32,
    rounded once to ``x``'s dtype."""

    momentum, eps = 0.9, 1e-5

    def __init__(self, channels: int, zero_scale: bool):
        super().__init__()
        self.zero_scale = zero_scale
        self.scale = nn.Parameter(torch.empty(channels))
        self.bias = nn.Parameter(torch.empty(channels))
        self.register_buffer("mean", torch.empty(channels,
                                                 dtype=torch.float32))
        self.register_buffer("var", torch.empty(channels,
                                                dtype=torch.float32))

    def forward(self, x, train: bool):
        """Train mode normalizes by this batch's statistics and writes
        the updated running ones into the ``mean`` and ``var`` it was
        given, in place (the train step hands it a copy of the state's
        and keeps that); eval mode normalizes by the running ones."""
        x32 = x.float()
        if train:
            dims = (0, 2, 3)
            mean = x32.mean(dims)
            var = ((x32 * x32).mean(dims) - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.eps) * self.scale
        y = (x32 - mean[:, None, None]) * mul[:, None, None] \
            + self.bias[:, None, None]
        return y.to(x.dtype)


class _BatchNormRelu(nn.Module):
    """The reference's ``_BatchNormRelu``: ``BatchNorm_0`` and an
    optional ReLU, the same factory surface as ``AdaptiveGroupNorm``."""

    def __init__(self, channels: int, relu: bool = False,
                 zero_scale: bool = False):
        super().__init__()
        self.relu = relu
        self.BatchNorm_0 = _BatchNorm(channels, zero_scale)

    def forward(self, x, train: bool = False):
        y = self.BatchNorm_0(x, train)
        return F.relu(y) if self.relu else y


def _norm(norm: str):
    """``(channels, relu=, zero_scale=) -> module`` for ``norm``: a class
    or a ``functools.partial`` of one (``_norm_name`` reads its name)."""
    if norm == "batch":
        return _BatchNormRelu
    if norm == "group":
        return AdaptiveGroupNorm
    if norm == "group_pallas":
        return functools.partial(AdaptiveGroupNorm, impl="pallas")
    if norm == "none":
        return _Identity
    raise ValueError(f"unknown norm {norm!r}")


def _norm_name(make) -> str:
    """The class name flax gives a norm built by ``make``: its modules
    are ``<name>_0``, ``<name>_1``, ... in each parent."""
    return getattr(make, "func", make).__name__


def s2d_input(x: torch.Tensor) -> torch.Tensor:
    """Space-to-depth, block 2: ``[N,H,W,C] -> [N,H/2,W/2,4C]`` with
    channel layout ``(s, t, c)`` (row offset slowest)."""
    n, h, w, c = x.shape
    x = x.reshape(n, h // 2, 2, w // 2, 2, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(n, h // 2, w // 2, 4 * c)


def s2d_stem_kernel(w7: torch.Tensor) -> torch.Tensor:
    """Transform a ``[7,7,C,O]`` (flax HWIO) stride-2 stem kernel into
    the equivalent ``[4,4,4C,O]`` stride-1 kernel over an ``s2d_input``
    image: zero-pad to 8x8 at the front, then fold each 2x2 spatial
    phase into the channel axis (same ``(s, t, c)`` layout)."""
    w8 = F.pad(w7, (0, 0, 0, 0, 1, 0, 1, 0))
    c_in, c_out = w7.shape[2], w7.shape[3]
    w = w8.reshape(4, 2, 4, 2, c_in, c_out)
    return w.permute(0, 2, 1, 3, 4, 5).reshape(4, 4, 4 * c_in, c_out)


class _Block(nn.Module):
    """A block whose norms, built by ``norm``, are named as flax names
    them (``_norm_name``), numbered in order of use."""

    def _add_norm(self, norm, *args, **kwargs):
        name = f"{_norm_name(norm)}_{self.num_norms}"
        self.add_module(name, norm(*args, **kwargs))
        self.num_norms += 1

    def _norm_at(self, i: int) -> nn.Module:
        return self.get_submodule(f"{self.norm_name}_{i}")


class BasicBlock(_Block):
    def __init__(self, in_channels: int, filters: int, stride: int, norm,
                 dtype: torch.dtype):
        super().__init__()
        self.norm_name, self.num_norms = _norm_name(norm), 0
        self.Conv_0 = Conv(in_channels, filters, (3, 3), stride,
                           use_bias=False, dtype=dtype)
        self._add_norm(norm, filters, relu=True)
        self.Conv_1 = Conv(filters, filters, (3, 3), use_bias=False,
                           dtype=dtype)
        # zero-init the last norm's scale so blocks start as identity
        self._add_norm(norm, filters, zero_scale=True)
        self.project = in_channels != filters or stride != 1
        if self.project:
            self.Conv_2 = Conv(in_channels, filters, (1, 1), stride,
                               use_bias=False, dtype=dtype)
            self._add_norm(norm, filters)

    def forward(self, x, train: bool = False):
        y = self._norm_at(0)(self.Conv_0(x), train)
        y = self._norm_at(1)(self.Conv_1(y), train)
        residual = (self._norm_at(2)(self.Conv_2(x), train)
                    if self.project else x)
        return F.relu(residual + y)


class BottleneckBlock(_Block):
    def __init__(self, in_channels: int, filters: int, stride: int, norm,
                 dtype: torch.dtype):
        super().__init__()
        out = 4 * filters
        self.norm_name, self.num_norms = _norm_name(norm), 0
        self.Conv_0 = Conv(in_channels, filters, (1, 1), use_bias=False,
                           dtype=dtype)
        self._add_norm(norm, filters, relu=True)
        self.Conv_1 = Conv(filters, filters, (3, 3), stride,
                           use_bias=False, dtype=dtype)
        self._add_norm(norm, filters, relu=True)
        self.Conv_2 = Conv(filters, out, (1, 1), use_bias=False,
                           dtype=dtype)
        # zero-init the last norm's scale so blocks start as identity
        self._add_norm(norm, out, zero_scale=True)
        self.project = in_channels != out or stride != 1
        if self.project:
            self.Conv_3 = Conv(in_channels, out, (1, 1), stride,
                               use_bias=False, dtype=dtype)
            self._add_norm(norm, out)

    def forward(self, x, train: bool = False):
        y = self._norm_at(0)(self.Conv_0(x), train)
        y = self._norm_at(1)(self.Conv_1(y), train)
        y = self._norm_at(2)(self.Conv_2(y), train)
        residual = (self._norm_at(3)(self.Conv_3(x), train)
                    if self.project else x)
        return F.relu(residual + y)


class FusedBottleneckBlock(nn.Module):
    """The bottleneck block through the fused-block kernels: the first
    1x1 conv + GN + ReLU is one kernel, the downsample projection
    (conv1x1 + GN) a second, and the 3x3 conv's GN, the second 1x1 conv,
    its GN, the residual add and the final ReLU a third; the 3x3 conv
    stays cuDNN's.  The same math as ``BottleneckBlock`` with
    ``norm="group"``.  With ``fuse_op1=False`` (``fusion="pallas_tail"``)
    the first 1x1 conv and the downsample stay ``Conv`` +
    ``AdaptiveGroupNorm`` and only the tail is fused.

    Parameters are flax's flat tree: ``conv1``, ``convd``, ``conv3`` raw
    ``[C_in, C_out]`` kernels (the JAX layout, which the kernels read),
    ``gn{1,2,3,d}_scale`` / ``_bias``, and ``conv2`` a nested conv; or,
    with ``fuse_op1=False``, ``conv1u``, ``gn1u``, ``convdu``, ``gndu``
    nested.  ``flax_init`` names the leaves that ``FlaxInit`` does not
    draw as zeros."""

    def __init__(self, in_channels: int, filters: int, stride: int,
                 dtype: torch.dtype, fuse_op1: bool = True):
        super().__init__()
        out = 4 * filters
        self.dtype, self.stride, self.fuse_op1 = dtype, stride, fuse_op1
        self.g_mid, self.g_out = math.gcd(32, filters), math.gcd(32, out)
        self.project = in_channels != out or stride != 1
        self.flax_init = {"conv3": "lecun_in", "gn2_scale": "ones"}
        if fuse_op1:
            self._raw("conv1", "gn1", in_channels, filters)
        else:
            self.conv1u = Conv(in_channels, filters, (1, 1), use_bias=False,
                               dtype=dtype)
            self.gn1u = AdaptiveGroupNorm(filters, relu=True)
        self.conv2 = Conv(filters, filters, (3, 3), stride, use_bias=False,
                          dtype=dtype)
        if self.project and fuse_op1:
            self._raw("convd", "gnd", in_channels, out)
        elif self.project:
            self.convdu = Conv(in_channels, out, (1, 1), stride,
                               use_bias=False, dtype=dtype)
            self.gndu = AdaptiveGroupNorm(out)
        self.conv3 = nn.Parameter(torch.empty(filters, out))
        for name, c in (("gn2", filters), ("gn3", out)):
            setattr(self, f"{name}_scale", nn.Parameter(torch.empty(c)))
            setattr(self, f"{name}_bias", nn.Parameter(torch.empty(c)))
        # gn3_scale stays zeros: the block starts as the identity

    def _raw(self, conv, norm, cin, cout):
        """A fused 1x1 conv's raw kernel and its norm's parameters."""
        setattr(self, conv, nn.Parameter(torch.empty(cin, cout)))
        setattr(self, f"{norm}_scale", nn.Parameter(torch.empty(cout)))
        setattr(self, f"{norm}_bias", nn.Parameter(torch.empty(cout)))
        self.flax_init.update({conv: "lecun_in", f"{norm}_scale": "ones"})

    def forward(self, x, train: bool = False):
        dt = self.dtype
        if self.fuse_op1:
            x = fused_block.channels_last(x)
            y = fused_block.fused_conv1x1_gn(
                x, self.conv1.to(dt), self.gn1_scale, self.gn1_bias,
                groups=self.g_mid, relu=True)
        else:
            y = self.gn1u(self.conv1u(x))
        y = self.conv2(y)
        if not self.project:
            residual = x
        elif self.fuse_op1:
            s = self.stride
            residual = fused_block.fused_conv1x1_gn(
                fused_block.channels_last(x[:, :, ::s, ::s]),
                self.convd.to(dt), self.gnd_scale, self.gnd_bias,
                groups=self.g_out, relu=False)
        else:
            residual = self.gndu(self.convdu(x))
        return fused_block.fused_bottleneck_tail(
            fused_block.channels_last(y), self.conv3.to(dt), self.gn2_scale,
            self.gn2_bias, self.gn3_scale, self.gn3_bias,
            fused_block.channels_last(residual), groups2=self.g_mid,
            groups3=self.g_out)


@register_model("resnet")
class ResNet(FlaxInit):
    """Configurable ResNet on NHWC input; ``stage_sizes=(3,4,6,3),
    bottleneck=True`` is ResNet-50."""

    takes_input_shape = True

    def __init__(self, input_shape: Sequence[int], num_classes: int = 1000,
                 stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 bottleneck: bool = True, width: int = 64,
                 norm: str = "group", dtype: str = "bfloat16",
                 stem: str = "conv", fusion: str = "none",
                 fusion_stages: Sequence[int] | None = None):
        super().__init__()
        if fusion in ("pallas_block", "pallas_tail"):
            if not bottleneck or norm != "group":
                raise ValueError(
                    f"fusion={fusion!r} implements the GroupNorm "
                    f"bottleneck block only (norm='group', "
                    f"bottleneck=True)")
        elif fusion != "none":
            raise ValueError(f"unknown fusion {fusion!r}")
        if stem not in ("conv", "space_to_depth"):
            raise ValueError(f"unknown stem {stem!r}")
        make_norm = _norm(norm)
        cd = compute_dtype(dtype)
        self.dtype, self.stem = cd, stem
        h, w, c = input_shape
        with torch.device("meta"):
            if stem == "space_to_depth":
                if h % 2 or w % 2:
                    raise ValueError(
                        f"stem='space_to_depth' needs even input height/"
                        f"width (the 2x2 phase fold), got {(h, w)}; "
                        f"use stem='conv' for odd sizes")
                self.Conv_0 = Conv(4 * c, width, (4, 4),
                                   padding=[(2, 1), (2, 1)],
                                   use_bias=False, dtype=cd)
            else:
                self.Conv_0 = Conv(c, width, (7, 7), 2,
                                   padding=[(3, 3), (3, 3)],
                                   use_bias=False, dtype=cd)
            self.stem_norm = f"{_norm_name(make_norm)}_0"
            self.add_module(self.stem_norm, make_norm(width, relu=True))
            block = BottleneckBlock if bottleneck else BasicBlock
            chans, counts, self.block_names = width, {}, []
            for stage, size in enumerate(stage_sizes):
                fuse = fusion != "none" and (fusion_stages is None
                                             or stage in fusion_stages)
                for j in range(size):
                    stride = 2 if stage > 0 and j == 0 else 1
                    filters = width * 2 ** stage
                    if fuse:
                        mod = FusedBottleneckBlock(
                            chans, filters, stride, cd,
                            fuse_op1=fusion == "pallas_block")
                    else:
                        mod = block(chans, filters, stride, make_norm, cd)
                    # flax numbers each class's instances on its own
                    kind = type(mod).__name__
                    name = f"{kind}_{counts.get(kind, 0)}"
                    counts[kind] = counts.get(kind, 0) + 1
                    self.add_module(name, mod)
                    self.block_names.append(name)
                    chans = 4 * filters if bottleneck else filters
            self.Dense_0 = Dense(chans, num_classes)
        self._init_from_flax()

    def forward(self, x, train: bool = False, rng=None):
        """``train``: flax's mode (BatchNorm's batch statistics and
        their update); ``rng``: unused (no dropout), taken as every
        model's forward takes it."""
        x = x.to(self.dtype)
        if self.stem == "space_to_depth":
            x = s2d_input(x)
        x = x.permute(0, 3, 1, 2)       # NHWC -> channels-last NCHW view
        x = self.get_submodule(self.stem_norm)(self.Conv_0(x), train)
        x = max_pool_same(x, 3, 2)
        for name in self.block_names:
            x = getattr(self, name)(x, train)
        return self.Dense_0(x.mean(dim=(2, 3)))


def ResNet18(input_shape, **kw) -> ResNet:
    kw.setdefault("stage_sizes", (2, 2, 2, 2))
    kw.setdefault("bottleneck", False)
    return ResNet(input_shape, **kw)


def ResNet50(input_shape, **kw) -> ResNet:
    kw.setdefault("stage_sizes", (3, 4, 6, 3))
    kw.setdefault("bottleneck", True)
    return ResNet(input_shape, **kw)
