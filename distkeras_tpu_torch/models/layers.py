"""Layers shared by the port's model families, spelled as flax
spells them: parameters stay f32 and each layer casts them (and its
input) to its compute dtype at every use, as flax's ``param_dtype`` /
``dtype`` pair does, so autograd through the cast hands back f32
gradients.

Images travel as ``[B, C, H, W]`` tensors in channels-last memory
(``torch.channels_last``), cuDNN's tensor-core layout on Hopper: the
models take the JAX package's NHWC input and ``permute`` it, a free
view.  ``Conv`` keeps its weight ``[O, I, kh, kw]`` (torch's OIHW;
``convert`` maps flax's HWIO) and pads as flax does: ``"SAME"`` pads
``(total // 2, total - total // 2)``, so a stride-2 3x3 conv of an even
size pads ``(0, 1)`` where torch's ``padding=1`` would pad ``(1, 1)``.

``FlaxInit.init_params`` draws flax's default initializers once:
kernels ``lecun_normal`` (truncated normal, std ``fan_in ** -0.5``),
biases 0, norm scales 1 (0 where a block zero-inits its last norm) and
norm biases 0; BatchNorm's running statistics start at mean 0, var 1.  A module whose leaves have other names (the fused
bottleneck's raw ``[C_in, C_out]`` kernels and ``gn1_scale``) names their
initializers in a ``flax_init`` dict.  Modules are built on the meta
device, so torch's own initializers draw nothing.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# flax's truncated normal is cut at two standard deviations; this is the
# std of the unit normal so cut, by which flax divides to keep the
# requested std (jax.nn.initializers.variance_scaling)
_TRUNC_STD = 0.87962566103423978


def lecun_normal(shape, generator=None, fan_in=None) -> torch.Tensor:
    """flax ``lecun_normal``: truncated normal of std ``fan_in ** -0.5``;
    for a torch weight ``[out, in, *kernel]`` ``fan_in`` defaults to ``in
    * prod(kernel)``."""
    if fan_in is None:
        fan_in = math.prod(shape[1:])
    std = fan_in ** -0.5 / _TRUNC_STD
    return nn.init.trunc_normal_(torch.empty(shape), 0.0, std, -2 * std,
                                 2 * std, generator=generator)


def compute_dtype(name: str) -> torch.dtype:
    if name not in DTYPES:
        raise ValueError(f"dtype={name!r} not one of {list(DTYPES)}")
    return DTYPES[name]


class Dense(nn.Module):
    """flax ``nn.Dense``: ``x @ kernel + bias`` in ``dtype``."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features))

    def forward(self, x):
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype),
                        self.bias.to(self.dtype))


def same_padding(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """flax/XLA ``"SAME"``: ``(low, high)`` padding of one spatial dim."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """flax ``nn.Conv`` on channels-last ``[B, C, H, W]``: ``padding`` is
    ``"SAME"`` or flax's explicit ``[(lo, hi), (lo, hi)]``."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel: Sequence[int], stride: int = 1,
                 padding="SAME", use_bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.stride, self.padding = dtype, stride, padding
        self.kernel = tuple(kernel)
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels, *self.kernel))
        self.bias = nn.Parameter(torch.empty(out_channels)) \
            if use_bias else None

    def _pads(self, x):
        if self.padding == "SAME":
            return [same_padding(x.shape[2 + i], self.kernel[i],
                                 self.stride) for i in range(2)]
        return [tuple(p) for p in self.padding]

    def forward(self, x):
        x = x.to(self.dtype)
        w = self.weight.to(self.dtype, memory_format=torch.channels_last)
        b = None if self.bias is None else self.bias.to(self.dtype)
        (h0, h1), (w0, w1) = self._pads(x)
        if h0 == h1 and w0 == w1:
            return F.conv2d(x, w, b, self.stride, (h0, w0))
        return F.conv2d(F.pad(x, (w0, w1, h0, h1)), w, b, self.stride)


def dropout(x: torch.Tensor, rate: float, train: bool,
            rng: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout(rate, deterministic=not train)``: in train mode
    each element is kept with probability ``1 - rate`` and a kept one
    becomes ``x / (1 - rate)``, in ``x``'s dtype; the identity in eval
    mode or at rate 0.  The mask comes from ``rng``, a
    ``torch.Generator`` on ``x``'s device (flax's ``"dropout"`` rng), so
    each training state draws its own."""
    if not train or rate == 0:
        return x
    if rng is None:
        raise ValueError("dropout in train mode draws its mask from a "
                         "generator: pass rng= (TrainState.rng)")
    if rate == 1:
        return torch.zeros_like(x)
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=rng, device=x.device) < keep_prob
    # a true division by the rate rounded to x's dtype, as jnp divides by
    # a Python float (CUDA turns a division by a Python scalar into a
    # product with its reciprocal)
    scale = torch.full((), keep_prob, dtype=x.dtype, device=x.device)
    return torch.where(keep, x / scale, torch.zeros_like(x))


def max_pool_same(x, window: int, stride: int):
    """flax ``nn.max_pool(..., padding="SAME")``: pads with -inf,
    ``(0, 1)`` at a stride-2 window of an even size."""
    (h0, h1), (w0, w1) = (same_padding(x.shape[2 + i], window, stride)
                          for i in range(2))
    x = F.pad(x, (w0, w1, h0, h1), value=float("-inf"))
    return F.max_pool2d(x, window, stride)


class Embed(nn.Module):
    """flax ``nn.Embed``: a table ``embedding [num, features]`` (flax's
    name and layout), looked up in ``dtype`` (the table cast first, as
    flax promotes it); initialized N(0, 1/features), flax's
    ``default_embed_init``."""

    flax_init = {"embedding": "embed"}

    def __init__(self, num_embeddings: int, features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.embedding = nn.Parameter(torch.empty(num_embeddings, features))

    def forward(self, idx):
        return F.embedding(idx, self.embedding.to(self.dtype))


class FlaxInit(nn.Module):
    """A model whose parameters come from one draw of flax's default
    initializers (``init_params``).  A module holding a norm ``scale``
    sets ``zero_scale = True`` where flax's ``scale_init`` is zeros; one
    with other leaves maps their names to ``"lecun_in"`` (a raw ``[in,
    out]`` kernel, fan-in ``in``), ``"ones"``, ``"embed"`` (flax's
    embedding init, N(0, 1/features)) or ``"orthogonal"`` (an orthogonal
    matrix, flax's ``orthogonal()``, the LSTM's recurrent kernels) in
    ``flax_init``; any other leaf is zeros."""

    def _init_from_flax(self):
        self.load_state_dict(self.init_params(), assign=True)

    def init_params(self, generator: Optional[torch.Generator] = None
                    ) -> dict:
        """f32 parameters on the CPU, drawn as the JAX package's flax
        initializers draw them (keys and shapes are the
        ``state_dict``'s), and the buffers as flax starts them
        (BatchNorm's running ``var`` 1, ``mean`` 0).  The draws come
        from ``generator`` (default: torch's global one), so they differ
        from the JAX package's: carry weights across with ``convert``."""
        out = {}
        for mname, mod in self.named_modules():
            pre = f"{mname}." if mname else ""
            named = getattr(mod, "flax_init", {})
            for leaf, b in mod.named_buffers(recurse=False):
                fill = torch.ones if leaf == "var" else torch.zeros
                out[pre + leaf] = fill(b.shape)
            for leaf, p in mod.named_parameters(recurse=False):
                if named.get(leaf) == "lecun_in":
                    out[pre + leaf] = lecun_normal(tuple(p.shape), generator,
                                                   fan_in=p.shape[0])
                elif named.get(leaf) == "ones":
                    out[pre + leaf] = torch.ones(p.shape)
                elif named.get(leaf) == "embed":
                    out[pre + leaf] = torch.randn(
                        tuple(p.shape), generator=generator) \
                        * p.shape[-1] ** -0.5
                elif named.get(leaf) == "orthogonal":
                    out[pre + leaf] = nn.init.orthogonal_(
                        torch.empty(tuple(p.shape)), generator=generator)
                elif leaf == "weight":
                    out[pre + leaf] = lecun_normal(tuple(p.shape), generator)
                elif leaf == "scale" and not getattr(mod, "zero_scale",
                                                     False):
                    out[pre + leaf] = torch.ones(p.shape)
                else:
                    out[pre + leaf] = torch.zeros(p.shape)
        return out
