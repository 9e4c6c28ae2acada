"""The port's ``ops/metrics.py`` and ``evaluators.py`` against the JAX
package's on the same arrays and the same scored ``Dataset``s: the
metrics to 1e-6, counts exactly, and every guard of
``tests/test_metrics.py`` with its exception type and message."""

import jax
import numpy as np
import pytest
import torch

from distkeras_tpu import evaluators as jax_eval
from distkeras_tpu.data import Dataset as JaxDataset
from distkeras_tpu.ops import metrics as jax_metrics
from distkeras_tpu_torch import Dataset, evaluators
from distkeras_tpu_torch.ops import metrics

jax.config.update("jax_platforms", "cpu")
torch.set_num_threads(1)

RNG = np.random.default_rng(0)
N, C = 97, 5
LOGITS = RNG.standard_normal((N, C)).astype(np.float32)
LABELS = RNG.integers(0, C, N).astype(np.int32)
PRED = RNG.integers(0, C, N).astype(np.int32)
SCORES = np.round(RNG.standard_normal(N), 1).astype(np.float32)  # ties
BINARY = (RNG.random(N) < 0.4).astype(np.int32)
SEQ_LOGITS = RNG.standard_normal((3, 7, 11)).astype(np.float32)
SEQ_LABELS = RNG.integers(0, 11, (3, 7)).astype(np.int32)

CASES = {
    "accuracy": lambda m: m.accuracy(LOGITS, LABELS),
    "binary_accuracy": lambda m: m.binary_accuracy(SCORES[:, None],
                                                   BINARY),
    "top_k_accuracy": lambda m: m.top_k_accuracy(LOGITS, LABELS, k=2),
    "perplexity": lambda m: m.perplexity(SEQ_LOGITS, SEQ_LABELS),
    "auc_roc": lambda m: m.auc_roc(SCORES, BINARY),
    "macro_auc_roc": lambda m: m.macro_auc_roc(LOGITS, LABELS),
    "confusion_matrix": lambda m: m.confusion_matrix(PRED, LABELS, C),
    **{f"prf_{avg}": (lambda m, avg=avg: m.precision_recall_f1(
        PRED, LABELS, C, average=avg))
       for avg in ("weighted", "macro", "micro")},
}


def _np(x):
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("name", sorted(CASES))
def test_metric_matches_jax(name):
    got, want = _np(CASES[name](metrics)), _np(CASES[name](jax_metrics))
    if name == "confusion_matrix":
        np.testing.assert_array_equal(got, want)
        assert got.sum() == N
        return
    for g, w in (zip(got.values(), want.values()) if isinstance(got, dict)
                 else [(got, want)]):
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)


def test_metrics_hand_checked_and_zero_division():
    cm = metrics.confusion_matrix([0, 1, 1, 2], [0, 1, 2, 2], 3)
    assert cm.tolist() == [[1, 0, 0], [0, 1, 0], [0, 1, 1]]
    # class 2 is never predicted: its precision is 0, not NaN
    s = metrics.precision_recall_f1([0, 0], [0, 2], 3, average="macro")
    assert np.isfinite([float(v) for v in s.values()]).all()
    assert float(metrics.perplexity(np.zeros((4, 8)), np.zeros(4, int))) \
        == pytest.approx(8.0)
    assert float(metrics.auc_roc([0.1, 0.9], [0, 1])) == 1.0


GUARDS = [
    (lambda m: m.auc_roc(np.array([0.1, 0.2]), np.array([1, 1])),
     "both classes"),
    (lambda m: m.auc_roc(np.array([0.1, 0.2]), np.array([0, 2])),
     "labels in"),
    (lambda m: m.macro_auc_roc(np.zeros(4), np.array([0, 1, 0, 1])),
     r"\[N, C\]"),
    (lambda m: m.macro_auc_roc(np.zeros((4, 2)), np.array([0, 1, 0, 1]),
                               num_classes=3), "does not match"),
    (lambda m: m.macro_auc_roc(np.zeros((4, 1)), np.zeros(4, int)),
     "at least 2"),
    (lambda m: m.macro_auc_roc(np.zeros((4, 3)), np.array([0, 1, 0, 1])),
     r"classes \[2\]"),
    (lambda m: m.macro_auc_roc(np.zeros((4, 2)), np.array([0, 1, 0, 5])),
     "out of range"),
    (lambda m: m.confusion_matrix(np.array([0, 3]), np.array([0, 1]), 3),
     "out of range"),
    (lambda m: m.precision_recall_f1(np.array([0]), np.array([0]), 2,
                                     average="harmonic"), "average"),
]


@pytest.mark.parametrize("i", range(len(GUARDS)))
def test_metric_guards_as_in_jax(i):
    fn, match = GUARDS[i]
    for m in (metrics, jax_metrics):
        with pytest.raises(ValueError, match=match):
            fn(m)


def _scored(pred):
    cols = {"prediction": pred, "label": LABELS,
            "binary": BINARY, "onehot": np.eye(C, dtype=np.float32)[LABELS]}
    return Dataset(cols), JaxDataset(cols)


EVALUATORS = [
    ("AccuracyEvaluator", {}, PRED),
    ("AccuracyEvaluator", {"label_col": "onehot"}, LOGITS),
    ("ClassificationEvaluator", {}, PRED),
    ("ClassificationEvaluator", {"metric": "precision",
                                 "average": "micro"}, PRED),
    ("ClassificationEvaluator", {"metric": "recall", "average": "macro",
                                 "num_classes": C}, LOGITS),
    ("ClassificationEvaluator", {"metric": "accuracy"}, PRED[:, None]),
    ("ClassificationEvaluator", {"metric": "auc", "average": "macro"},
     LOGITS),
    ("BinaryClassificationEvaluator", {"label_col": "binary"}, SCORES),
    ("BinaryClassificationEvaluator", {"label_col": "binary",
                                       "metric": "accuracy"},
     SCORES[:, None]),
    ("LossEvaluator", {"fn": lambda p, y: (p - y) ** 2}, PRED),
]


@pytest.mark.parametrize("i", range(len(EVALUATORS)))
def test_evaluator_matches_jax(i):
    name, kw, pred = EVALUATORS[i]
    ours, theirs = _scored(pred)
    got = getattr(evaluators, name)(**kw).evaluate(ours)
    want = getattr(jax_eval, name)(**kw).evaluate(theirs)
    assert isinstance(got, float)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_metrics_from_logits_matches_jax():
    for labels in (LABELS, LABELS[:, None], np.eye(C)[LABELS]):
        got = evaluators.metrics_from_logits(LOGITS, labels, top_k=3)
        want = jax_eval.metrics_from_logits(LOGITS, labels, top_k=3)
        assert got.keys() == want.keys() == {"accuracy", "top3_accuracy"}
        for k in got:
            assert got[k] == pytest.approx(want[k], abs=1e-6)
    got = evaluators.metrics_from_logits(SCORES[:, None], BINARY)
    assert got == pytest.approx(jax_eval.metrics_from_logits(
        SCORES[:, None], BINARY), abs=1e-6)


EVAL_GUARDS = [
    (lambda e: e.ClassificationEvaluator(metric="kappa"), "unknown metric"),
    (lambda e: e.ClassificationEvaluator(metric="auc"), "macro"),
    (lambda e: e.ClassificationEvaluator(average="harmonic"),
     "unknown average"),
    (lambda e: e.ClassificationEvaluator(average="macro"),
     "explicit num_classes"),
    (lambda e: e.BinaryClassificationEvaluator(metric="f1"),
     "unknown metric"),
]


@pytest.mark.parametrize("i", range(len(EVAL_GUARDS)))
def test_evaluator_constructor_guards_as_in_jax(i):
    fn, match = EVAL_GUARDS[i]
    for e in (evaluators, jax_eval):
        with pytest.raises(ValueError, match=match):
            fn(e)


@pytest.mark.parametrize("name,kw,pred,match", [
    ("AccuracyEvaluator", {}, SCORES, "BinaryClassification"),
    ("AccuracyEvaluator", {"label_col": "nested"}, PRED, "do not align"),
    ("ClassificationEvaluator", {"metric": "auc", "average": "macro"},
     PRED, "per-class scores"),
    ("ClassificationEvaluator", {}, PRED[:0], "empty"),
    ("BinaryClassificationEvaluator", {"label_col": "binary"}, LOGITS,
     "one score per row"),
    ("BinaryClassificationEvaluator", {"label_col": "binary",
                                       "metric": "accuracy"},
     np.clip(SCORES, 0, 1), "threshold"),
    ("BinaryClassificationEvaluator", {"label_col": "binary"}, SCORES[:0],
     "empty")])
def test_evaluate_guards_as_in_jax(name, kw, pred, match):
    n = len(pred)
    cols = {"prediction": pred, "label": LABELS[:n], "binary": BINARY[:n],
            # [N, 2, 3]: its argmax over the last axis keeps two ids a row
            "nested": np.zeros((n, 2, 3), np.float32)}
    for pkg, data in ((evaluators, Dataset), (jax_eval, JaxDataset)):
        with pytest.raises(ValueError, match=match):
            getattr(pkg, name)(**kw).evaluate(data(cols))
