"""The port's ``ModelPredictor`` and ``evaluate_model`` against the JAX
package's: the same weights (drawn for the port, carried by
``convert``), the same rows.  Logits agree to 1e-5 on an MLP and within
7e-3 of their rms on the conv models (XLA:CPU's convolutions round
differently with the batch, ROADMAP.md §3); ``output="class"`` and
``"prob"`` follow; the ragged tail is padded and stripped."""

import jax
import numpy as np
import pytest
import torch

from distkeras_tpu import evaluators as jax_eval
from distkeras_tpu import predictors as jax_pred
from distkeras_tpu.data import Dataset as JaxDataset
from distkeras_tpu.models import model_config as jax_config
from distkeras_tpu_torch import (Dataset, SingleTrainer, build_model,
                                 convert)
from distkeras_tpu_torch.evaluators import evaluate_model
from distkeras_tpu_torch.models import model_config
from distkeras_tpu_torch.predictors import ModelPredictor

jax.config.update("jax_platforms", "cpu")
torch.set_num_threads(1)

MODELS = {
    "mlp": ("mlp", (8,), dict(num_classes=4, hidden=(16,)), 1e-5),
    "convnet": ("convnet", (8, 8, 1), dict(num_classes=4, widths=(4, 8),
                                           dense=16), 7e-3),
    "resnet": ("resnet", (16, 16, 3), dict(num_classes=4,
                                           stage_sizes=(1, 1), width=8,
                                           norm="group_pallas"), 7e-3),
}


def _setup(name, rows=37, seed=0):
    family, shape, kw, tol = MODELS[name]
    model = build_model(model_config(family, shape, **kw), device="cpu")
    rng = np.random.default_rng(seed)
    sd = {k: torch.from_numpy((rng.standard_normal(v.shape) * 0.3
                               + k.endswith("scale")).astype(np.float32))
          for k, v in model.state_dict().items()}
    cols = {"features": rng.standard_normal((rows, *shape))
            .astype(np.float32),
            "label": rng.integers(0, 4, rows).astype(np.int32)}
    return (jax_config(family, shape, **kw), model_config(family, shape,
                                                          **kw),
            sd, cols, tol)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_predictor_matches_jax(name):
    jspec, cfg, sd, cols, tol = _setup(name)
    jv = convert.variables_to_flax(sd)
    want = jax_pred.ModelPredictor(jspec, jv, batch_size=4).predict(
        JaxDataset(cols))["prediction"]
    # a ragged tail: 37 rows in batches of 16 (the last padded from 5)
    pred = ModelPredictor(cfg, sd, batch_size=16, device="cpu")
    got = pred.predict(Dataset(cols))
    assert got.column_names == ["features", "label", "prediction"]
    logits = got["prediction"]
    assert logits.shape == want.shape == (37, 4)
    rms = np.sqrt(np.mean(np.square(want)))
    assert np.abs(logits - want).max() <= tol * max(rms, 1.0)
    # each row's logits do not depend on the batch it rode in
    alone = ModelPredictor(cfg, sd, batch_size=37, device="cpu")(
        Dataset(cols))["prediction"]
    np.testing.assert_allclose(alone, logits, rtol=1e-5, atol=1e-5)
    cls = ModelPredictor(cfg, sd, output="class", batch_size=16,
                         device="cpu").predict(Dataset(cols))["prediction"]
    assert cls.dtype == np.int32
    np.testing.assert_array_equal(cls, np.argmax(logits, -1))
    prob = ModelPredictor(cfg, sd, output="prob", batch_size=16,
                          device="cpu").predict(Dataset(cols))["prediction"]
    np.testing.assert_allclose(prob.sum(-1), 1.0, rtol=1e-6)
    np.testing.assert_allclose(
        prob, np.asarray(jax.nn.softmax(logits, -1)), rtol=1e-5, atol=1e-6)


def test_predictor_takes_specs_modules_and_new_variables():
    _, cfg, sd, cols, _ = _setup("mlp", rows=8)
    model = build_model(cfg, device="cpu")
    by_module = ModelPredictor(model, sd, batch_size=4)
    want = by_module(Dataset(cols))["prediction"]
    with torch.no_grad():
        model.load_state_dict(sd)
        np.testing.assert_allclose(
            want, model(torch.from_numpy(cols["features"])).numpy(),
            rtol=1e-6)
    _, _, other, _, _ = _setup("mlp", rows=8, seed=1)
    by_module.variables = other
    assert not np.allclose(by_module(Dataset(cols))["prediction"], want)


@pytest.mark.parametrize("kw,exc,match", [
    ({"output": "logprob"}, ValueError, "unknown output"),
    ({"model_parallel": 0}, ValueError, "model_parallel must be"),
    ({"tp_rules": {}}, ValueError, "tp_rules given"),
    ({"model_parallel": 2}, NotImplementedError, r"§1 item 9"),
    ({"num_shards": 2}, NotImplementedError, r"§1 item 9")])
def test_predictor_guards(kw, exc, match):
    _, cfg, sd, _, _ = _setup("mlp", rows=4)
    with pytest.raises(exc, match=match):
        ModelPredictor(cfg, sd, device="cpu", **kw)
    with pytest.raises(TypeError, match="ModelSpec"):
        ModelPredictor(object(), sd)
    multi = {**cfg, "kwargs": {**cfg["kwargs"], "outputs": [2, 2]}}
    with pytest.raises(NotImplementedError, match=r"§1 item 10"):
        ModelPredictor(multi, sd, device="cpu")


def test_evaluate_model_matches_jax_on_trained_variables():
    """After training, ``evaluate_model`` equals the JAX package's on the
    same variables, and the last ``eval_accuracy`` the trainer recorded
    (through the same predictor at batch 256)."""
    _, cfg, _, cols, _ = _setup("convnet", rows=300)
    data = Dataset(cols)
    t = SingleTrainer(cfg, batch_size=32, num_epoch=2, device="cpu",
                      worker_optimizer="adam", learning_rate=3e-3,
                      loss="sparse_categorical_crossentropy")
    v = t.train(data.take(256), eval_dataset=data)
    got = evaluate_model(cfg, v, data, batch_size=256, top_k=2,
                         device="cpu")
    assert t.history["eval_accuracy"][-1] == got["accuracy"]
    jspec = jax_config(*MODELS["convnet"][:2], **MODELS["convnet"][2])
    want = jax_eval.evaluate_model(jspec, convert.variables_to_flax(v),
                                   JaxDataset(cols), top_k=2)
    assert got.keys() == want.keys()
    # a prediction near a tie may flip between the packages
    for k in got:
        assert abs(got[k] - want[k]) <= 2 / len(data)
    assert evaluate_model(cfg, v, data, label_col=["label"],
                          device="cpu") == {"label": {
                              "accuracy": got["accuracy"]}}
