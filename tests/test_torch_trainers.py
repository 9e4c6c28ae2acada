"""Port ``SingleTrainer`` (and the data, init and conversion it stands
on) against the JAX package's.

Both trainers start from one set of weights (the JAX model initialized
with ``attn="dense"``, mapped by ``convert.params_from_flax``) and see
the same batches (``Dataset.shuffle`` draws the same permutation in both
packages).  In f32 the epoch losses agree to 1e-5 and the trained
parameters to 2e-5: the two differ in summation order, which Adam
carries through 16 steps.  One exception, stated and bounded: the
attention key biases get no gradient in exact arithmetic (softmax
ignores a shift that is the same for every key), so their gradients
are rounding noise, which Adam divides by its own square root into full
steps of size ``lr``; there both packages only stay within ``steps * lr``
of the start.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu.data import Dataset as JaxDataset
from distkeras_tpu.data import datasets as jax_datasets
from distkeras_tpu.models import ModelSpec
from distkeras_tpu.models import model_config as jax_config
from distkeras_tpu.trainers import SingleTrainer as JaxSingleTrainer
from distkeras_tpu_torch import Dataset, SingleTrainer, build_model, convert
from distkeras_tpu_torch.data import datasets
from distkeras_tpu_torch.models import model_config
from distkeras_tpu_torch.workers import (TrainState, make_eval_step,
                                         make_train_step, resolve_optimizer)

jax.config.update("jax_platforms", "cpu")
# tiny shapes: one thread each keeps the parallel test workers off
# each other's cores
torch.set_num_threads(1)

LM = dict(vocab_size=64, num_layers=2, d_model=32, num_heads=4,
          num_kv_heads=2, max_len=16, dtype="float32", flash_attn=True)
TRAIN = dict(loss="sparse_categorical_crossentropy",
             worker_optimizer="adam", learning_rate=3e-3, batch_size=8,
             num_epoch=2, seed=0)
LOSS_TOL, PARAM_TOL = 1e-5, 2e-5


def _jax_params(cfg, seed=0):
    spec = jax_config("transformer_lm", (cfg["max_len"],),
                      input_dtype="int32", **cfg)
    init = ModelSpec.from_config(spec).build().clone(attn="dense",
                                                     flash_attn=False)
    variables = init.init(jax.random.key(seed),
                          jnp.zeros((2, cfg["max_len"]), jnp.int32))
    return spec, variables["params"]


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(x) for p, x in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_single_trainer_matches_jax():
    spec, params = _jax_params(LM)
    jt = JaxSingleTrainer(spec, **TRAIN)
    jv = jt.train(jax_datasets.lm_synth(64, seq_len=16, vocab_size=64),
                  initial_variables={"params": params})
    pt = SingleTrainer(model_config("transformer_lm", (16,),
                                    input_dtype="int32", **LM),
                       device="cpu", **TRAIN)
    start = convert.params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                            params))
    pv = pt.train(datasets.lm_synth(64, seq_len=16, vocab_size=64),
                  initial_variables=start)
    assert sorted(pt.history) == sorted(jt.history) == [
        "epoch_loss", "segment_stall_s"]
    np.testing.assert_allclose(pt.history["epoch_loss"],
                               jt.history["epoch_loss"], rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    assert pt.history["epoch_loss"][1] < pt.history["epoch_loss"][0]
    assert pt.training_time > 0
    steps = 2 * 64 // 8
    assert pt.step_metrics["loss"].shape == (steps,)
    assert np.isfinite(pt.step_metrics["grad_norm"]).all()
    assert all(v.dtype == torch.float32 for v in pv.values())
    want, got = _leaves(jv["params"]), _leaves(convert.params_to_flax(
        pv, num_heads=LM["num_heads"]))
    first = _leaves(params)
    assert want.keys() == got.keys()
    for key in want:
        if "['key']['bias']" in key:
            for x in (want[key], got[key]):
                assert np.abs(x - first[key]).max() <= steps * 3e-3 * 1.01
            continue
        np.testing.assert_allclose(got[key], want[key], rtol=PARAM_TOL,
                                   atol=PARAM_TOL, err_msg=key)
    # the trained weights are loaded into the trainer's model too
    assert torch.equal(pt.model.lm_head.weight, pv["lm_head.weight"])


def test_train_step_metrics_and_eval_match_jax_losses():
    """One step: loss and grad_norm against a JAX value_and_grad of the
    same model; the eval step reads the updated parameters."""
    from distkeras_tpu.ops.losses import categorical_crossentropy

    cfg = dict(LM, flash_attn=False)
    spec, params = _jax_params(cfg, seed=1)
    jm = ModelSpec.from_config(spec).build()
    data = datasets.lm_synth(8, seq_len=16, vocab_size=64, seed=9)
    x, y = data["features"], data["label"]

    def loss(p):
        return categorical_crossentropy(jm.apply({"params": p}, x), y)

    want_loss, grads = jax.jit(jax.value_and_grad(loss))(params)
    want_norm = float(jnp.sqrt(sum(jnp.sum(g * g) for g in
                                   jax.tree_util.tree_leaves(grads))))
    model = build_model(model_config("transformer_lm", (16,),
                                     input_dtype="int32", **cfg),
                        device="cpu")
    tx = resolve_optimizer("sgd", 0.1)
    state = TrainState.create(
        model, convert.params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                               params)), tx)
    step = make_train_step(model, "sparse_categorical_crossentropy", tx)
    batch = {"features": torch.from_numpy(x), "label": torch.from_numpy(y)}
    state, metrics = step(state, batch)
    assert state.step == 1 and metrics["aux_loss"].item() == 0.0
    np.testing.assert_allclose(metrics["loss"].item(), float(want_loss),
                               rtol=LOSS_TOL)
    np.testing.assert_allclose(metrics["grad_norm"].item(), want_norm,
                               rtol=1e-4)
    ev = make_eval_step(model, "sparse_categorical_crossentropy")(
        state.variables(), batch)
    assert ev["logits"].shape == (8, 16, 64)
    assert ev["loss"].item() < metrics["loss"].item()


def test_bf16_step_updates_f32_masters():
    """A bf16 model trains f32 master parameters: an update smaller than
    a bf16 ulp still moves them, as flax's f32 parameters move."""
    cfg = dict(LM, dtype="bfloat16")
    model = build_model(model_config("transformer_lm", (16,),
                                     input_dtype="int32", **cfg),
                        device="cpu")
    tx = resolve_optimizer("sgd", 1e-6)
    state = TrainState.create(model, model.state_dict(), tx)
    before = {n: p.detach().clone() for n, p in state.params.items()}
    data = datasets.lm_synth(8, seq_len=16, vocab_size=64, seed=2)
    step = make_train_step(model, "sparse_categorical_crossentropy", tx)
    state, _ = step(state, {k: torch.from_numpy(data[k])
                            for k in ("features", "label")})
    w = "blocks.0.attn.query.weight"
    assert state.params[w].dtype == torch.float32
    moved = state.params[w] != before[w]
    assert moved.any()
    # every moved entry moved by less than the bf16 spacing there
    assert torch.equal(state.params[w][moved].bfloat16(),
                       before[w][moved].bfloat16())


def test_dataset_and_lm_synth_match_jax():
    want = jax_datasets.lm_synth(50, seq_len=12, vocab_size=40, seed=3)
    got = datasets.lm_synth(50, seq_len=12, vocab_size=40, seed=3)
    assert got.column_names == want.column_names and len(got) == len(want)
    for c in want.column_names:
        np.testing.assert_array_equal(got[c], want[c])
    for seed in (0, 7):
        a, b = got.shuffle(seed), want.shuffle(seed)
        np.testing.assert_array_equal(a["features"], b["features"])
    for bs in (8, 7, 50, 64):
        for drop in (True, False):
            assert got.num_batches(bs, drop) == want.num_batches(bs, drop)
            ga = list(got.batches(bs, drop_remainder=drop))
            wa = list(want.batches(bs, drop_remainder=drop))
            assert len(ga) == len(wa)
            for x, y in zip(ga, wa):
                np.testing.assert_array_equal(x["label"], y["label"])
    small = Dataset({"a": np.arange(5), "b": np.arange(5) * 2.0})
    jsmall = JaxDataset({"a": np.arange(5), "b": np.arange(5) * 2.0})
    assert "a" in small and "c" not in small
    np.testing.assert_array_equal(small.take(3)["b"], jsmall.take(3)["b"])
    assert small.select(["b"]).column_names == ["b"]
    with pytest.raises(ValueError, match="lengths differ"):
        Dataset({"a": np.arange(3), "b": np.arange(4)})


def test_default_init_follows_flax():
    """Each parameter's std and mean against the JAX model's init at
    d=256 (vocab 512): within 10 % of the JAX std (and 0.01 of it for
    the mean), which a draw of >=65k values meets while torch's own
    defaults miss it by a factor of up to 16; biases and LayerNorm
    parameters exactly 0 or 1."""
    cfg = dict(vocab_size=512, num_layers=1, d_model=256, num_heads=4,
               max_len=256, dtype="bfloat16")
    _, params = _jax_params(cfg)
    want = _leaves(params)
    model = build_model(model_config("transformer_lm", (256,),
                                     input_dtype="int32", **cfg),
                        device="cpu")
    sd = model.state_dict()
    got = _leaves(convert.params_to_flax(sd, num_heads=4))
    assert got.keys() == want.keys()
    for key, w in want.items():
        g = got[key]
        if key.endswith("['bias']") or key.endswith("['scale']"):
            assert np.array_equal(g, w), key
            continue
        assert abs(g.std() / w.std() - 1) < 0.1, (key, g.std(), w.std())
        assert abs(g.mean()) < 0.01 * w.std() + 2e-3, key
    gen = torch.Generator().manual_seed(0)
    draws = model.init_params(gen)
    assert all(v.dtype == torch.float32 for v in draws.values())
    assert draws.keys() == sd.keys()


def test_trainer_rejects_what_is_not_ported():
    cfg = model_config("transformer_lm", (16,), input_dtype="int32", **LM)
    for kw in ({"profile_dir": "x"},
               {"loss": ["mse", "mse"], "label_col": ["a", "b"]},
               {"loss": ["mse"], "label_col": "a"}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            SingleTrainer(cfg, device="cpu", **kw)
    one = SingleTrainer(cfg, device="cpu", loss=["mse"], label_col=["y"])
    assert (one.loss, one.label_col) == ("mse", "y")
    t = SingleTrainer(cfg, device="cpu", **TRAIN)
    data = datasets.lm_synth(16, seq_len=16, vocab_size=64)
    with pytest.raises(ValueError, match="smaller than one batch"):
        t.train(data.take(4))
