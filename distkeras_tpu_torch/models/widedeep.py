"""Wide & Deep of the Criteo baseline configuration, the port of
``distkeras_tpu/models/widedeep.py``.

Input is one float matrix ``[B, num_dense + num_categorical]`` as the
ETL transformer pipeline (``distkeras_tpu_torch.data``) assembles it:
the first ``num_dense`` columns are normalized dense features, the rest
integer category ids (already hash-bucketed by
``HashBucketTransformer``).  The ids are cast to int (toward zero, as
``astype(int32)``), clipped to ``[0, vocab_size - 1]`` and offset per
feature into one table each for the wide and the deep arm.  Parameters
keep flax's names (``wide_table/embedding``, ``wide_dense``,
``deep_table/embedding``, ``Dense_i``), so ``convert`` maps them leaf by
leaf.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from distkeras_tpu_torch.models.core import register_model
from distkeras_tpu_torch.models.layers import (Dense, Embed, FlaxInit,
                                               compute_dtype)


@register_model("wide_deep")
class WideAndDeep(FlaxInit):
    """Wide arm: per-feature scalar lookups (a linear model over the
    one-hot categoricals) plus a Dense over the dense features; deep
    arm: the concatenated embeddings and dense features through a ReLU
    MLP with an f32 head; logits ``wide + deep`` in f32."""

    def __init__(self, num_dense: int = 13, num_categorical: int = 26,
                 vocab_size: int = 10000, embed_dim: int = 16,
                 deep: Sequence[int] = (256, 128, 64),
                 num_classes: int = 2, dtype: str = "float32"):
        super().__init__()
        cd = compute_dtype(dtype)
        self.num_dense, self.num_categorical = num_dense, num_categorical
        self.vocab_size, self.num_deep = vocab_size, len(deep)
        rows = num_categorical * vocab_size
        widths = [num_categorical * embed_dim + num_dense, *deep]
        with torch.device("meta"):
            self.wide_table = Embed(rows, num_classes, cd)
            self.wide_dense = Dense(num_dense, num_classes, cd)
            self.deep_table = Embed(rows, embed_dim, cd)
            for i, (a, b) in enumerate(zip(widths, widths[1:])):
                self.add_module(f"Dense_{i}", Dense(a, b, cd))
            self.add_module(f"Dense_{len(deep)}",
                            Dense(widths[-1], num_classes))
        self._init_from_flax()

    def forward(self, x, train: bool = False, rng=None):
        """``train``/``rng``: the families' common signature (this model
        has no dropout)."""
        dense = x[:, :self.num_dense]
        cats = x[:, self.num_dense:].to(torch.int32).clamp(
            0, self.vocab_size - 1)
        offsets = torch.arange(self.num_categorical, device=x.device,
                               dtype=torch.int32) * self.vocab_size
        ids = cats + offsets[None, :]
        wide = self.wide_table(ids).sum(dim=1) + self.wide_dense(dense)
        emb = self.deep_table(ids)                          # [B, C, E]
        h = torch.cat([emb.reshape(x.shape[0], -1),
                       dense.to(emb.dtype)], dim=-1)
        for i in range(self.num_deep):
            h = F.relu(getattr(self, f"Dense_{i}")(h))
        deep = getattr(self, f"Dense_{self.num_deep}")(h)
        return wide.float() + deep
