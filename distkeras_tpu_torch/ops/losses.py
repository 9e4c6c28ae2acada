"""Loss functions, resolvable by Keras-style string names: the port of
``distkeras_tpu/ops/losses.py`` with optax's formulas written out.

Every loss computes in float32 whatever the model's compute dtype and
reduces to a batch mean; any callable ``(logits, labels) -> scalar``
passes through ``resolve_loss``.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

LossFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def categorical_crossentropy(logits: torch.Tensor,
                             labels: torch.Tensor) -> torch.Tensor:
    """Cross-entropy from logits.  Accepts integer class labels (any
    leading shape, e.g. ``[B]`` or ``[B, T]``) or one-hot/soft labels
    with the same shape as ``logits``."""
    logits = logits.float()
    if labels.dim() == logits.dim():
        # optax.softmax_cross_entropy
        per = -(labels.float() * torch.log_softmax(logits, -1)).sum(-1)
    else:
        # optax.softmax_cross_entropy_with_integer_labels
        picked = logits.gather(-1, labels.long().unsqueeze(-1))[..., 0]
        per = torch.logsumexp(logits, -1) - picked
    return per.mean()


def binary_crossentropy(logits: torch.Tensor,
                        labels: torch.Tensor) -> torch.Tensor:
    """Sigmoid cross-entropy from a single logit per row."""
    logits = logits.float()
    if logits.dim() > labels.dim():
        logits = logits.squeeze(-1)
    labels = labels.float()
    # optax.sigmoid_binary_cross_entropy
    return (-labels * F.logsigmoid(logits)
            - (1.0 - labels) * F.logsigmoid(-logits)).mean()


def mean_squared_error(pred: torch.Tensor,
                       target: torch.Tensor) -> torch.Tensor:
    return torch.square(pred.float() - target.float()).mean()


def mean_absolute_error(pred: torch.Tensor,
                        target: torch.Tensor) -> torch.Tensor:
    return torch.abs(pred.float() - target.float()).mean()


LOSSES: dict[str, LossFn] = {
    "categorical_crossentropy": categorical_crossentropy,
    "sparse_categorical_crossentropy": categorical_crossentropy,
    "binary_crossentropy": binary_crossentropy,
    "mse": mean_squared_error,
    "mean_squared_error": mean_squared_error,
    "mae": mean_absolute_error,
    "mean_absolute_error": mean_absolute_error,
}


def resolve_loss(loss: str | LossFn) -> LossFn:
    if callable(loss):
        return loss
    if loss not in LOSSES:
        raise KeyError(f"unknown loss {loss!r}; known: {sorted(LOSSES)}")
    return LOSSES[loss]
