"""Evaluators, the port of ``distkeras_tpu/evaluators.py``: accuracy,
classification and loss metrics over a ``Dataset`` holding a prediction
column (from ``ModelPredictor``), and ``evaluate_model``, which runs the
model itself.  The same numpy handling of prediction and label columns
as the reference, on the port's ``ops.metrics``.  Multi-output models
(a label column per head) are not ported yet (ROADMAP.md §1 item 10).
"""

from __future__ import annotations

from typing import Callable, Mapping

import numpy as np

from distkeras_tpu_torch.data.dataset import Dataset
from distkeras_tpu_torch.ops import metrics as M
from distkeras_tpu_torch.predictors import ModelPredictor


def _normalize_class_labels(labels: np.ndarray) -> np.ndarray:
    """Class ids from a label column of ids ``[N]``, a column vector of
    ids ``[N, 1]`` (squeezed: its argmax would zero every label) or
    one-hot rows ``[N, C]`` (argmax'd)."""
    if labels.ndim > 1:
        if labels.shape[-1] > 1:
            labels = np.argmax(labels, axis=-1)
        else:
            labels = np.squeeze(labels, axis=-1)
    return labels


def _aligned_pred_labels(dataset: Dataset, prediction_col: str,
                         label_col: str) -> tuple[np.ndarray, np.ndarray]:
    """Class-id ``(pred, labels)`` of a scored dataset.  Predictions may
    be class ids or logits/probabilities (argmax'd); labels as in
    ``_normalize_class_labels``."""
    pred = np.asarray(dataset[prediction_col])
    if pred.ndim > 1:
        if pred.shape[-1] > 1:
            pred = np.argmax(pred, axis=-1)
        else:
            pred = np.squeeze(pred, axis=-1)
    labels = np.asarray(dataset[label_col])
    if labels.ndim > pred.ndim:
        labels = _normalize_class_labels(labels)
    if np.issubdtype(pred.dtype, np.floating):
        # a float column that is not integral class ids is a score
        # column: compared raw against labels it would give ~0 accuracy
        if pred.size and not np.array_equal(pred, np.round(pred)):
            raise ValueError(
                f"prediction column {prediction_col!r} holds "
                f"non-integral float scores, not class ids; for "
                f"one-score-per-row binary outputs use "
                f"BinaryClassificationEvaluator (or argmax multi-class "
                f"scores into class ids first)")
        pred = pred.astype(np.int64)
    if labels.shape != pred.shape:
        raise ValueError(
            f"prediction shape {pred.shape} and label shape "
            f"{labels.shape} do not align")
    return pred, labels


class AccuracyEvaluator:
    """Classification accuracy from a prediction column."""

    def __init__(self, prediction_col: str = "prediction",
                 label_col: str = "label"):
        self.prediction_col = prediction_col
        self.label_col = label_col

    def evaluate(self, dataset: Dataset) -> float:
        pred, labels = _aligned_pred_labels(
            dataset, self.prediction_col, self.label_col)
        return float(np.mean(pred == labels))


class ClassificationEvaluator:
    """Multi-class precision / recall / F1 / accuracy, or one-vs-rest
    macro AUC (``metric="auc"``, from per-class scores ``[N, C]``), over
    a scored dataset.  ``average`` as in
    ``ops.metrics.precision_recall_f1`` (``"auc"``: ``"macro"`` only).
    ``num_classes`` is inferred from the data (max id + 1, or the score
    width) except for ``average="macro"`` on the count metrics, whose
    denominator is the class count: there it is required."""

    def __init__(self, metric: str = "f1", average: str = "weighted",
                 prediction_col: str = "prediction",
                 label_col: str = "label",
                 num_classes: int | None = None):
        if metric not in ("f1", "precision", "recall", "accuracy",
                          "auc"):
            raise ValueError(
                f"unknown metric {metric!r}; expected 'f1', "
                f"'precision', 'recall', 'accuracy', or 'auc'")
        if metric == "auc":
            if average != "macro":
                raise ValueError(
                    f"metric='auc' supports average='macro' only "
                    f"(one-vs-rest), got {average!r}")
        elif average not in ("weighted", "macro", "micro"):
            raise ValueError(
                f"unknown average {average!r}; expected 'weighted', "
                f"'macro', or 'micro'")
        if average == "macro" and num_classes is None \
                and metric not in ("accuracy", "auc"):
            raise ValueError(
                "average='macro' needs an explicit num_classes (its "
                "denominator is the class count; inferring it from "
                "the evaluated split would make the score depend on "
                "which classes happen to appear)")
        self.metric = metric
        self.average = average
        self.prediction_col = prediction_col
        self.label_col = label_col
        self.num_classes = num_classes

    def evaluate(self, dataset: Dataset) -> float:
        if self.metric == "auc":
            scores = np.asarray(dataset[self.prediction_col])
            if scores.ndim != 2 or scores.shape[-1] < 2:
                raise ValueError(
                    f"metric='auc' needs per-class scores [N, C] in "
                    f"{self.prediction_col!r} (run ModelPredictor with "
                    f"output='logits'), got shape {scores.shape}")
            labels = _normalize_class_labels(
                np.asarray(dataset[self.label_col]))
            if scores.size == 0:
                raise ValueError("cannot evaluate an empty dataset")
            return float(M.macro_auc_roc(scores, labels,
                                         num_classes=self.num_classes))
        pred, labels = _aligned_pred_labels(
            dataset, self.prediction_col, self.label_col)
        if pred.size == 0:
            raise ValueError("cannot evaluate an empty dataset")
        if self.metric == "accuracy":
            return float(np.mean(pred == labels))
        n = self.num_classes or int(max(pred.max(), labels.max())) + 1
        scores = M.precision_recall_f1(pred, labels, num_classes=n,
                                       average=self.average)
        return float(scores[self.metric])


class BinaryClassificationEvaluator:
    """AUC-ROC (default) or accuracy over one score per row (``[N]`` or
    ``[N, 1]`` logits or probabilities), labels in {0, 1}.
    ``threshold`` (accuracy only): scores above it are class 1; without
    one it is 0.0, and scores that all lie in [0, 1] (probability-
    shaped) raise instead of silently returning the base rate."""

    def __init__(self, metric: str = "auc",
                 prediction_col: str = "prediction",
                 label_col: str = "label",
                 threshold: float | None = None):
        if metric not in ("auc", "accuracy"):
            raise ValueError(f"unknown metric {metric!r}; expected "
                             f"'auc' or 'accuracy'")
        self.metric = metric
        self.prediction_col = prediction_col
        self.label_col = label_col
        self._threshold_given = threshold is not None
        self.threshold = 0.0 if threshold is None else float(threshold)

    def evaluate(self, dataset: Dataset) -> float:
        scores = np.asarray(dataset[self.prediction_col])
        if scores.ndim > 1:
            if scores.shape[-1] != 1:
                raise ValueError(
                    f"binary evaluation needs one score per row, got "
                    f"shape {scores.shape}")
            scores = np.squeeze(scores, axis=-1)
        labels = np.asarray(dataset[self.label_col]).reshape(-1)
        if scores.shape != labels.shape:
            raise ValueError(
                f"score shape {scores.shape} and label shape "
                f"{labels.shape} do not align")
        if scores.size == 0:
            raise ValueError("cannot evaluate an empty dataset")
        if self.metric == "accuracy":
            if not self._threshold_given and scores.min() >= 0.0 \
                    and scores.max() <= 1.0:
                raise ValueError(
                    "all scores lie in [0, 1] (probability-shaped); "
                    "the default threshold 0.0 would classify every "
                    "row as class 1.  Pass threshold=0.5 for "
                    "probabilities (or threshold=0.0 explicitly for "
                    "logits that happen to land in [0, 1])")
            return float(M.binary_accuracy(scores - self.threshold,
                                           labels))
        return float(M.auc_roc(scores, labels))


class LossEvaluator:
    """Mean of an arbitrary per-row loss ``fn(prediction, label)``."""

    def __init__(self, fn: Callable[[np.ndarray, np.ndarray], np.ndarray],
                 prediction_col: str = "prediction",
                 label_col: str = "label"):
        self.fn = fn
        self.prediction_col = prediction_col
        self.label_col = label_col

    def evaluate(self, dataset: Dataset) -> float:
        return float(np.mean(self.fn(
            np.asarray(dataset[self.prediction_col]),
            np.asarray(dataset[self.label_col]))))


def metrics_from_logits(logits, labels, *,
                        top_k: int | None = None) -> dict[str, float]:
    """Accuracy metrics from raw logits.  Labels: ids ``[N]``, a column
    vector ``[N, 1]`` or one-hot ``[N, C]``.  A single-logit head uses
    ``binary_accuracy``; ``top_k`` adds ``top{k}_accuracy`` for
    multi-class heads."""
    logits = np.asarray(logits)
    labels = np.asarray(labels)
    if labels.ndim == logits.ndim:
        labels = _normalize_class_labels(labels)
    if logits.shape[-1] == 1:
        return {"accuracy": float(M.binary_accuracy(logits, labels))}
    out = {"accuracy": float(M.accuracy(logits, labels))}
    if top_k is not None and logits.shape[-1] > top_k:
        out[f"top{top_k}_accuracy"] = float(
            M.top_k_accuracy(logits, labels, k=top_k))
    return out


def evaluate_model(model, variables: Mapping, dataset: Dataset, *,
                   features_col: str = "features", label_col="label",
                   batch_size: int = 512, top_k: int | None = None,
                   device=None) -> dict:
    """One call: batch inference to logits (``ModelPredictor``), then
    ``metrics_from_logits``.  A one-element ``label_col`` list returns
    ``{label: metrics}``, as the reference does for a single head; more
    heads raise (multi-output models, ROADMAP.md §1 item 10)."""
    heads = list(label_col) if isinstance(label_col, (list, tuple)) \
        else None
    if heads is not None and len(heads) != 1:
        raise NotImplementedError(
            "evaluate_model over several heads (multi-output models) is "
            "not ported to distkeras_tpu_torch yet (ROADMAP.md §1 "
            "item 10)")
    predictor = ModelPredictor(model, variables, features_col=features_col,
                               output="logits", batch_size=batch_size,
                               device=device)
    scored = predictor.predict(dataset)
    label = heads[0] if heads else label_col
    m = metrics_from_logits(scored["prediction"], dataset[label],
                            top_k=top_k)
    return {label: m} if heads else m
