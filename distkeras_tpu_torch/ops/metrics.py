"""Eval metrics, the port of ``distkeras_tpu/ops/metrics.py``: plain
functions on tensors or numpy arrays (numpy is taken in as tensors),
returning 0-d f32 tensors, with the reference's guards and its
zero-division convention (a class with no predictions or no true rows
scores 0).  The port has no tracing, so every guard the reference runs
on concrete inputs runs always."""

from __future__ import annotations

import numpy as np
import torch

from distkeras_tpu_torch.ops.losses import categorical_crossentropy


def _t(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.asarray(x))


def accuracy(logits, labels) -> torch.Tensor:
    """Fraction of rows whose argmax matches the integer label."""
    pred = torch.argmax(_t(logits), dim=-1)
    return (pred == _t(labels).to(pred.dtype)).float().mean()


def binary_accuracy(logits, labels) -> torch.Tensor:
    logits, labels = _t(logits), _t(labels)
    if logits.dim() > labels.dim():
        logits = logits.squeeze(-1)
    pred = (logits > 0).int()
    return (pred == labels.int()).float().mean()


def top_k_accuracy(logits, labels, k: int = 5) -> torch.Tensor:
    top = torch.topk(_t(logits), k, dim=-1).indices
    hit = (top == _t(labels)[..., None].to(top.dtype)).any(dim=-1)
    return hit.float().mean()


def perplexity(logits, labels) -> torch.Tensor:
    """exp(mean next-token cross-entropy): the same cross-entropy the
    trainers minimize (``ops.losses.categorical_crossentropy``).
    Uniform logits give exactly ``V``; a perfect model gives 1."""
    return torch.exp(categorical_crossentropy(_t(logits), _t(labels)))


def auc_roc(scores, labels) -> torch.Tensor:
    """Area under the ROC curve by the Mann-Whitney U statistic
    (rank-based, tie-aware).  ``scores``: any monotone ranking;
    ``labels`` in {0, 1}.  Bad labels or a single class raise."""
    scores = _t(scores).reshape(-1).float().contiguous()
    labels = _t(labels).reshape(-1).float()
    if labels.numel():
        if not torch.isin(labels, labels.new_tensor([0.0, 1.0])).all():
            raise ValueError(
                f"auc_roc needs labels in {{0, 1}}, got values in "
                f"[{labels.min()}, {labels.max()}]")
        if labels.min() == labels.max():
            raise ValueError("auc_roc needs both classes present, got "
                             f"only label {labels.min()}")
    ordered = torch.sort(scores).values
    # tie-aware average rank (1-based): the mean of the left and right
    # insertion positions among the sorted scores
    lo = torch.searchsorted(ordered, scores, side="left")
    hi = torch.searchsorted(ordered, scores, side="right")
    ranks = (lo + hi + 1.0) / 2.0
    pos = labels.sum()
    neg = labels.shape[0] - pos
    u = (ranks * labels).sum() - pos * (pos + 1.0) / 2.0
    return torch.where(pos * neg > 0,
                       u / torch.clamp(pos * neg, min=1e-30),
                       torch.full_like(u, float("nan")))


def macro_auc_roc(scores, labels, num_classes: int | None = None
                  ) -> torch.Tensor:
    """One-vs-rest macro-averaged AUC-ROC of ``[N, C]`` scores against
    integer class ids: each class c scores ``auc_roc(scores[:, c],
    labels == c)``, and every class weighs the same.  A class without
    positive or without negative rows raises."""
    scores = _t(scores)
    if scores.dim() != 2:
        raise ValueError(f"macro_auc_roc needs [N, C] per-class scores, "
                         f"got shape {tuple(scores.shape)}")
    n_cls = num_classes if num_classes is not None else scores.shape[-1]
    if n_cls != scores.shape[-1]:
        raise ValueError(f"num_classes={n_cls} does not match score width "
                         f"{scores.shape[-1]}")
    if n_cls < 2:
        raise ValueError("macro_auc_roc needs at least 2 classes; use "
                         "auc_roc for single-score binary rows")
    labels = _t(labels).reshape(-1).long()
    if labels.numel():
        if labels.min() < 0 or labels.max() >= n_cls:
            raise ValueError(
                f"label ids out of range [0, {n_cls}): labels in "
                f"[{labels.min()}, {labels.max()}] — pass num_classes "
                f"(or widen the score matrix) to cover every class")
        counts = torch.bincount(labels, minlength=n_cls)
        missing = [c for c in range(n_cls)
                   if counts[c] == 0 or counts[c] == labels.numel()]
        if missing:
            raise ValueError(
                f"one-vs-rest AUC is undefined for classes {missing}: "
                f"each class needs both positive and negative rows in "
                f"the evaluated split")
    per_class = [auc_roc(scores[:, c], (labels == c).float())
                 for c in range(n_cls)]
    return torch.stack(per_class).mean()


def confusion_matrix(pred, labels, num_classes: int) -> torch.Tensor:
    """``[C, C]`` counts, rows the true class, columns the predicted.
    Class ids outside ``[0, num_classes)`` raise."""
    pred, labels = _t(pred).long(), _t(labels).long()
    if pred.numel() and (pred.min() < 0 or pred.max() >= num_classes
                         or labels.min() < 0
                         or labels.max() >= num_classes):
        raise ValueError(
            f"class ids out of range [0, {num_classes}): "
            f"pred in [{pred.min()}, {pred.max()}], "
            f"labels in [{labels.min()}, {labels.max()}]")
    idx = labels * num_classes + pred
    return torch.bincount(idx.reshape(-1),
                          minlength=num_classes * num_classes) \
        .reshape(num_classes, num_classes).int()


def precision_recall_f1(pred, labels, num_classes: int,
                        average: str = "weighted"
                        ) -> dict[str, torch.Tensor]:
    """Multi-class precision, recall and F1 from class-id predictions.
    ``average``: ``'weighted'`` (class scores weighted by true-class
    frequency), ``'macro'`` (unweighted class mean) or ``'micro'``
    (global counts; accuracy for single-label rows)."""
    cm = confusion_matrix(pred, labels, num_classes).float()
    tp = torch.diagonal(cm)
    pred_tot = cm.sum(dim=0)
    true_tot = cm.sum(dim=1)
    if average == "micro":
        p = tp.sum() / torch.clamp(cm.sum(), min=1.0)
        return {"precision": p, "recall": p, "f1": p}
    zero = tp.new_zeros(())
    prec = torch.where(pred_tot > 0, tp / torch.clamp(pred_tot, min=1.0),
                       zero)
    rec = torch.where(true_tot > 0, tp / torch.clamp(true_tot, min=1.0),
                      zero)
    denom = prec + rec
    f1 = torch.where(denom > 0, 2.0 * prec * rec
                     / torch.clamp(denom, min=1e-30), zero)
    if average == "macro":
        w = torch.full_like(tp, 1.0 / num_classes)
    elif average == "weighted":
        w = true_tot / torch.clamp(true_tot.sum(), min=1.0)
    else:
        raise ValueError(f"unknown average {average!r}; expected "
                         f"'weighted', 'macro', or 'micro'")
    return {"precision": (prec * w).sum(), "recall": (rec * w).sum(),
            "f1": (f1 * w).sum()}
