"""ConvNet of the CIFAR-10 baseline config, the port of
``distkeras_tpu/models/convnet.py``: conv blocks (conv-relu-conv-relu-
pool) and a dense head, the last layer in f32, with dropout after the
dense layer's ReLU where ``dropout_rate > 0``."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from distkeras_tpu_torch.models.core import register_model
from distkeras_tpu_torch.models.layers import (Conv, Dense, FlaxInit,
                                               compute_dtype, dropout)


@register_model("convnet")
class ConvNet(FlaxInit):
    """Takes NHWC images; parameters keep flax's names (``Conv_i``,
    ``Dense_i``)."""

    takes_input_shape = True

    def __init__(self, input_shape: Sequence[int], num_classes: int = 10,
                 widths: Sequence[int] = (64, 128, 256), dense: int = 256,
                 dropout_rate: float = 0.0, dtype: str = "float32"):
        super().__init__()
        cd = compute_dtype(dtype)
        h, w, c = input_shape
        with torch.device("meta"):
            for i, width in enumerate(widths):
                self.add_module(f"Conv_{2 * i}", Conv(c, width, (3, 3),
                                                      dtype=cd))
                self.add_module(f"Conv_{2 * i + 1}",
                                Conv(width, width, (3, 3), dtype=cd))
                c, h, w = width, h // 2, w // 2
            self.Dense_0 = Dense(h * w * c, dense, cd)
            self.Dense_1 = Dense(dense, num_classes)
        self.num_convs, self.dropout_rate = 2 * len(widths), dropout_rate
        self._init_from_flax()

    def forward(self, x, train: bool = False, rng=None):
        """``train``: flax's mode (dropout on); ``rng``: the generator
        the dropout mask comes from."""
        x = x.permute(0, 3, 1, 2)       # NHWC -> channels-last NCHW view
        for i in range(0, self.num_convs, 2):
            x = F.relu(getattr(self, f"Conv_{i}")(x))
            x = F.relu(getattr(self, f"Conv_{i + 1}")(x))
            x = F.max_pool2d(x, 2, 2)
        # flatten in flax's (H, W, C) order
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = dropout(F.relu(self.Dense_0(x)), self.dropout_rate, train, rng)
        return self.Dense_1(x)
