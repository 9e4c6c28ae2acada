"""MLP of the MNIST baseline config, the port of
``distkeras_tpu/models/mlp.py``: a dense stack, ``[hidden...] ->
num_classes`` logits, the last layer in f32, with dropout after each
hidden layer's ReLU where ``dropout_rate > 0``."""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F

from distkeras_tpu_torch.models.core import register_model
from distkeras_tpu_torch.models.layers import (Dense, FlaxInit,
                                               compute_dtype, dropout)


@register_model("mlp")
class MLP(FlaxInit):
    """Dense stack; parameters keep flax's names (``Dense_i``)."""

    takes_input_shape = True

    def __init__(self, input_shape: Sequence[int], num_classes: int = 10,
                 hidden: Sequence[int] = (500, 500),
                 dropout_rate: float = 0.0, dtype: str = "float32"):
        super().__init__()
        cd = compute_dtype(dtype)
        widths = [math.prod(input_shape), *hidden]
        with torch.device("meta"):
            for i, (a, b) in enumerate(zip(widths, widths[1:])):
                self.add_module(f"Dense_{i}", Dense(a, b, cd))
            self.add_module(f"Dense_{len(hidden)}",
                            Dense(widths[-1], num_classes))
        self.num_hidden, self.dropout_rate = len(hidden), dropout_rate
        self._init_from_flax()

    def forward(self, x, train: bool = False, rng=None):
        """``train``: flax's mode (dropout on); ``rng``: the generator
        the dropout masks come from."""
        x = x.reshape(x.shape[0], -1)
        for i in range(self.num_hidden):
            x = F.relu(getattr(self, f"Dense_{i}")(x))
            x = dropout(x, self.dropout_rate, train, rng)
        return getattr(self, f"Dense_{self.num_hidden}")(x)
