"""BiLSTM text classifier of the IMDB baseline configuration, the port of
``distkeras_tpu/models/lstm.py``: Embed -> BiLSTM -> masked mean pool
-> dense head, token id 0 the padding.

The cells are flax 0.12.3's ``OptimizedLSTMCell``: gates i, f, g, o;
input kernels ``ii/if/ig/io`` without bias, recurrent kernels
``hi/hf/hg/ho`` with bias; ``c' = f c + i g``, ``h' = o tanh(c')``;
carries start at zero.  Parameters keep flax's names
(``OptimizedLSTMCell_{0,1}/<gate>/{kernel,bias}``, ``Embed_0``,
``Dense_{0,1}``), so ``convert`` maps them leaf by leaf.  The forward
direction runs over all T positions (``nn.RNN``: the outputs past a
row's length are computed and masked out of the pool); the reverse one
runs over each row flipped within its length ``sum(tokens != 0)``, the
positions from the length on flipped after it (flax's
``flip_sequences``), and its outputs are flipped back by the same index
gather, which is its own inverse.

The recurrence takes one of two routes: ``"fused"`` (default), one call
of torch's LSTM op a direction (cuDNN on the card), the four kernels of
each weight stacked in its ``[i, f, g, o]`` order, flax's bias as
``bias_hh`` and ``bias_ih`` zero; ``"loop"``, the plain version, an
explicit time loop of the same cell.  The JAX package computes the
recurrence with ``lax.scan``, no Pallas kernel, so neither route is a
kernel port.  In f32 the routes agree to rounding; in bf16 the loop
keeps flax's f32 carries and the fused route runs the op in bf16.
``recurrence_calls`` counts each route's calls (one per direction).
"""

from __future__ import annotations

import threading

import torch
import torch.nn.functional as F
from torch import nn

from distkeras_tpu_torch.models.core import register_model
from distkeras_tpu_torch.models.layers import (Dense, Embed, FlaxInit,
                                               compute_dtype, dropout)

GATES = ("i", "f", "g", "o")

#: calls of each recurrence route since the last reset (one a direction)
recurrence_calls = {"fused": 0, "loop": 0}
_count_lock = threading.Lock()


def _note(route: str) -> None:
    with _count_lock:
        recurrence_calls[route] += 1


class _Kernel(nn.Module):
    """One of the cell's ``DenseParams``: ``weight [out, in]`` (torch's
    layout of flax's ``kernel [in, out]``) and, for a recurrent kernel,
    ``bias``, initialized orthogonal (flax's ``recurrent_kernel_init``);
    input kernels take flax's ``lecun_normal``."""

    def __init__(self, in_features: int, out_features: int,
                 recurrent: bool):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        if recurrent:
            self.bias = nn.Parameter(torch.empty(out_features))
            self.flax_init = {"weight": "orthogonal"}


class OptimizedLSTMCell(nn.Module):
    """flax's ``OptimizedLSTMCell``'s parameters; the recurrence over a
    sequence is ``lstm_scan``."""

    def __init__(self, in_features: int, hidden: int):
        super().__init__()
        self.hidden = hidden
        for g in GATES:
            self.add_module(f"i{g}", _Kernel(in_features, hidden, False))
            self.add_module(f"h{g}", _Kernel(hidden, hidden, True))

    def stacked(self, dtype: torch.dtype):
        """``(w_ih [4H, E], w_hh [4H, H], b_hh [4H])`` in torch's gate
        order, in ``dtype`` (differentiable: the gradients reach each
        gate's kernel)."""
        w_ih = torch.cat([getattr(self, f"i{g}").weight for g in GATES])
        w_hh = torch.cat([getattr(self, f"h{g}").weight for g in GATES])
        b_hh = torch.cat([getattr(self, f"h{g}").bias for g in GATES])
        return w_ih.to(dtype), w_hh.to(dtype), b_hh.to(dtype)


def lstm_fused(x, w_ih, w_hh, b_hh):
    """The recurrence over ``x [B, T, E]`` by torch's LSTM op (cuDNN on
    the card), zero carries: outputs ``[B, T, H]``."""
    _note("fused")
    b, h = x.shape[0], w_hh.shape[1]
    zeros = x.new_zeros(1, b, h)
    out, _, _ = torch.lstm(x, (zeros, zeros),
                           (w_ih, w_hh, torch.zeros_like(b_hh), b_hh),
                           True, 1, 0.0, torch.is_grad_enabled(), False,
                           True)
    return out


def lstm_loop(x, w_ih, w_hh, b_hh):
    """The plain version: flax's cell step by step.  The gate products
    in ``x``'s dtype, the carries f32 (flax's ``param_dtype``), the
    outputs f32."""
    _note("loop")
    b, t = x.shape[:2]
    h = w_hh.shape[1]
    c = x.new_zeros(b, h, dtype=torch.float32)
    hh = x.new_zeros(b, h, dtype=torch.float32)
    xi = x @ w_ih.T                                   # [B, T, 4H]
    outs = []
    for s in range(t):
        z = (hh.to(x.dtype) @ w_hh.T + b_hh) + xi[:, s]
        zi, zf, zg, zo = z.chunk(4, dim=-1)
        i, f, o = torch.sigmoid(zi), torch.sigmoid(zf), torch.sigmoid(zo)
        c = f * c + i * torch.tanh(zg)
        hh = o * torch.tanh(c)
        outs.append(hh)
    return torch.stack(outs, dim=1)


ROUTES = {"fused": lstm_fused, "loop": lstm_loop}


def flip_index(lengths: torch.Tensor, t: int) -> torch.Tensor:
    """flax's ``flip_sequences`` as gather indices ``[B, T]``: position s
    takes ``(T - 1 - s + length) % T`` (each row reversed within its
    length, the rest reversed after it); the map is its own inverse."""
    s = torch.arange(t - 1, -1, -1, device=lengths.device)
    return (s[None, :] + lengths[:, None]) % t


@register_model("bilstm")
class BiLSTMClassifier(FlaxInit):
    """Embed -> BiLSTM -> masked mean pool -> [dropout] -> Dense, ReLU
    -> f32 Dense.  ``recurrence``: ``"fused"`` or ``"loop"`` (see the
    module's docstring)."""

    def __init__(self, vocab_size: int = 20000, embed_dim: int = 128,
                 hidden_dim: int = 128, num_classes: int = 2,
                 dropout_rate: float = 0.0, dtype: str = "float32"):
        super().__init__()
        self.dtype = compute_dtype(dtype)
        self.dropout_rate = dropout_rate
        self.recurrence = "fused"
        with torch.device("meta"):
            self.Embed_0 = Embed(vocab_size, embed_dim, self.dtype)
            self.OptimizedLSTMCell_0 = OptimizedLSTMCell(embed_dim,
                                                         hidden_dim)
            self.OptimizedLSTMCell_1 = OptimizedLSTMCell(embed_dim,
                                                         hidden_dim)
            self.Dense_0 = Dense(2 * hidden_dim, hidden_dim, self.dtype)
            self.Dense_1 = Dense(hidden_dim, num_classes)
        self._init_from_flax()

    def forward(self, tokens, train: bool = False, rng=None):
        """``train``: flax's mode (dropout on); ``rng``: the generator
        the dropout mask comes from."""
        run = ROUTES[self.recurrence]
        tokens = tokens.to(torch.int32)
        live = tokens != 0
        mask = live.to(self.dtype)[..., None]                # [B, T, 1]
        x = self.Embed_0(tokens)                             # [B, T, E]
        t = x.shape[1]
        fwd = run(x, *self.OptimizedLSTMCell_0.stacked(self.dtype))
        idx = flip_index(live.sum(dim=1), t)[..., None]
        bwd = run(torch.take_along_dim(x, idx, dim=1),
                  *self.OptimizedLSTMCell_1.stacked(self.dtype))
        bwd = torch.take_along_dim(bwd, idx, dim=1)
        x = torch.cat([fwd, bwd], dim=-1)
        x = (x * mask).sum(dim=1) / mask.sum(dim=1).clamp(min=1.0)
        x = dropout(x, self.dropout_rate, train, rng)
        x = F.relu(self.Dense_0(x))
        return self.Dense_1(x)
