"""The port's Wide & Deep and BiLSTM families (BASELINE.md rows 4-5)
against the JAX package's flax modules, and the baseline configurations
of ``tests/test_baseline_configs.py`` trained by the port.

Weights are drawn for the port's model and mapped to flax with
``convert.params_to_flax`` (the flax apply is then jitted); inputs come
from a numpy seed.  Logits and every parameter's gradient (of a random
cotangent) agree per element within ``TOL * (|flax| + rms(flax))``, f32
summation order; the BiLSTM is checked on both recurrence routes with
ragged rows, an all-padding row and an interior 0."""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu import trainers as jax_trainers
from distkeras_tpu.data import datasets as jax_datasets
from distkeras_tpu.models import build_model as jax_build
from distkeras_tpu_torch import (ADAG, DOWNPOUR, DynSGD, build_model,
                                 convert)
from distkeras_tpu_torch.data import (AssembleTransformer,
                                      HashBucketTransformer,
                                      MinMaxTransformer, Pipeline, datasets)
from distkeras_tpu_torch.evaluators import AccuracyEvaluator
from distkeras_tpu_torch.models import lstm, model_config
from distkeras_tpu_torch.predictors import ModelPredictor

jax.config.update("jax_platforms", "cpu")
torch.set_num_threads(1)

TOL = 1e-5
ROOT = Path(__file__).resolve().parent.parent
BILSTM = model_config("bilstm", (12,), input_dtype="int32", vocab_size=50,
                      embed_dim=8, hidden_dim=6)
WIDE_DEEP = model_config("wide_deep", (10,), num_dense=4,
                         num_categorical=6, vocab_size=50, embed_dim=8,
                         deep=(32, 16))


def _tokens():
    rng = np.random.default_rng(0)
    tok = rng.integers(1, 50, size=(5, 12)).astype(np.int32)
    tok[0, 8:] = 0            # ragged
    tok[1, 5] = 0             # an interior 0
    tok[2, :] = 0             # all padding
    tok[3, 3:] = 0
    return tok


def _criteo_rows():
    rng = np.random.default_rng(1)
    dense = rng.normal(size=(7, 4))
    cats = rng.integers(-3, 60, size=(7, 6)) + 0.7   # clipped and cast
    return np.concatenate([dense, cats], 1).astype(np.float32)


CASES = {"bilstm": (BILSTM, _tokens), "wide_deep": (WIDE_DEEP, _criteo_rows)}


def _close(got, want, what):
    rms = np.sqrt(np.mean(np.square(want)))
    bad = np.abs(got - want) > TOL * (np.abs(want) + rms) + 1e-12
    assert not bad.any(), (what, np.abs(got - want).max(), rms)


def _flax_run(cfg, tree, x, cot):
    model = jax_build(cfg)

    def loss(p):
        out = model.apply({"params": p}, jnp.asarray(x))
        return jnp.sum(out * cot), out

    (_, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, tree))
    return np.asarray(out), jax.tree_util.tree_map(np.asarray, grads)


@pytest.mark.parametrize("case,route", [("bilstm", "fused"),
                                        ("bilstm", "loop"),
                                        ("wide_deep", None)])
def test_logits_and_gradients_match_flax(case, route):
    cfg, inputs = CASES[case]
    torch.manual_seed(3)
    model = build_model(cfg, device="cpu")
    if route:
        model.recurrence = route
    x = inputs()
    tree = convert.params_to_flax(model.state_dict())
    cot = np.random.default_rng(2).normal(size=(len(x), 2)).astype(
        np.float32)
    want_out, want_grads = _flax_run(cfg, tree, x, cot)
    params = dict(model.named_parameters())
    out = model(torch.tensor(x))
    grads = torch.autograd.grad((out * torch.tensor(cot)).sum(),
                                list(params.values()))
    _close(out.detach().numpy(), want_out, "logits")
    got = convert.params_from_flax(want_grads)
    for (name, _), g in zip(params.items(), grads):
        _close(g.numpy(), got[name].numpy(), name)


def test_flip_index_is_flax_flip_sequences_and_its_own_inverse():
    from flax.linen.recurrent import flip_sequences

    tok = _tokens()
    lengths = (tok != 0).sum(1)
    x = np.arange(tok.size, dtype=np.float32).reshape(tok.shape)[..., None]
    want = np.asarray(flip_sequences(jnp.asarray(x), jnp.asarray(lengths),
                                     1, False))
    idx = lstm.flip_index(torch.tensor(lengths), tok.shape[1])[..., None]
    got = torch.take_along_dim(torch.tensor(x), idx, dim=1)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        torch.take_along_dim(got, idx, dim=1).numpy(), x)


def test_recurrence_routes_agree_and_count():
    torch.manual_seed(4)
    model = build_model(BILSTM, device="cpu")
    x = torch.tensor(_tokens())
    for route in ("fused", "loop"):
        lstm.recurrence_calls[route] = 0
    model.recurrence = "loop"
    loop = model(x)
    model.recurrence = "fused"
    fused = model(x)
    assert lstm.recurrence_calls == {"fused": 2, "loop": 2}
    _close(fused.detach().numpy(), loop.detach().numpy(), "routes")


def _flax_init(cfg):
    """The flax model's own init (jitted: eager flax RNN init is slow)."""
    x = jnp.zeros((2, *cfg["input_shape"]), cfg["input_dtype"])
    params = jax.jit(jax_build(cfg).init)(jax.random.key(0), x)["params"]
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize("case", sorted(CASES))
def test_params_round_trip(case):
    cfg, _ = CASES[case]
    torch.manual_seed(5)
    sd = build_model(cfg, device="cpu").state_dict()
    tree = convert.params_to_flax(sd)
    flax_tree = _flax_init(cfg)
    assert jax.tree_util.tree_structure(tree) == \
        jax.tree_util.tree_structure(flax_tree)
    for a, b in zip(jax.tree_util.tree_leaves(tree),
                    jax.tree_util.tree_leaves(flax_tree)):
        assert a.shape == b.shape and a.dtype == b.dtype
    back = convert.params_from_flax(tree)
    assert back.keys() == sd.keys()
    assert all(torch.equal(back[k], sd[k]) for k in sd)
    # the host arm's path: the tree copied into live parameters
    model = build_model(cfg, device="cpu")
    params = dict(model.named_parameters())
    convert.copy_from_flax(params, tree)
    assert all(torch.equal(params[k], sd[k]) for k in params)
    again = convert.params_tree(sd)
    assert jax.tree_util.tree_structure(again) == \
        jax.tree_util.tree_structure(flax_tree)


def test_bilstm_tree_maps_through_the_generic_path():
    """A BiLSTM tree has ``Embed_0`` but no ``pos_embed``: it maps leaf
    by leaf, never through the LM mapper."""
    tree = convert.params_to_flax(build_model(BILSTM,
                                              device="cpu").state_dict())
    assert "Embed_0" in tree and "pos_embed" not in tree
    sd = convert.params_from_flax(tree)
    assert "Embed_0.embedding" in sd and "embed.weight" not in sd
    assert sd["OptimizedLSTMCell_1.if.weight"].shape == (6, 8)


def test_lm_tree_still_maps_as_before():
    cfg = model_config("transformer_lm", (16,), input_dtype="int32",
                       vocab_size=32, num_layers=2, d_model=16,
                       num_heads=2, max_len=16, dtype="float32")
    sd = build_model(cfg, device="cpu").state_dict()
    tree = convert.params_to_flax(sd, num_heads=2)
    back = convert.params_from_flax(tree)
    assert back.keys() == sd.keys() and "embed.weight" in back
    assert all(torch.equal(back[k], sd[k]) for k in sd)
    broken = dict(tree)
    del broken["LayerNorm_0"]
    with pytest.raises(ValueError, match="TransformerLM"):
        convert.params_from_flax(broken)


@pytest.mark.parametrize("case", sorted(CASES))
def test_init_statistics_follow_flax(case):
    """Each leaf of >= 1000 values: its std within 10 % of the flax
    init's, its mean within 4 standard errors of 0; biases exactly 0;
    the LSTM's recurrent kernels orthogonal, as flax's ``orthogonal()``
    draws them."""
    big = {"bilstm": model_config("bilstm", (8,), input_dtype="int32",
                                  vocab_size=512, embed_dim=64,
                                  hidden_dim=64),
           "wide_deep": model_config("wide_deep", (10,), num_dense=4,
                                     num_categorical=6, vocab_size=1000,
                                     embed_dim=8, deep=(64, 64))}[case]
    torch.manual_seed(6)
    got = convert.params_to_flax(build_model(big, device="cpu")
                                 .state_dict())
    want = _flax_init(big)
    flat_got = {jax.tree_util.keystr(p): x for p, x in
                jax.tree_util.tree_flatten_with_path(got)[0]}
    flat_want = {jax.tree_util.keystr(p): x for p, x in
                 jax.tree_util.tree_flatten_with_path(want)[0]}
    assert flat_got.keys() == flat_want.keys()
    for key, w in flat_want.items():
        g = flat_got[key]
        if key.endswith("['bias']"):
            assert np.array_equal(g, w), key
            continue
        if key.split("']")[-3].endswith(("['hi", "['hf", "['hg", "['ho")):
            np.testing.assert_allclose(g.T @ g, np.eye(len(g)), atol=1e-5)
            np.testing.assert_allclose(w.T @ w, np.eye(len(w)), atol=1e-5)
        if w.size < 1000:
            continue
        assert abs(g.std() / w.std() - 1) < 0.1, (key, g.std(), w.std())
        # the mean within 4 standard errors of 0
        assert abs(g.mean()) < 4 * w.std() / np.sqrt(w.size), key


# -- the baseline configurations, trained by the port ------------------------

def test_imdb_bilstm_dynsgd():
    """BASELINE.md row 4 at ``tests/test_baseline_configs.py``'s size."""
    data = datasets.imdb_synth(1024, seq_len=32, vocab_size=200, seed=3)
    cfg = model_config("bilstm", (32,), input_dtype="int32",
                       vocab_size=200, embed_dim=16, hidden_dim=16,
                       num_classes=2)
    t = DynSGD(cfg, num_workers=4, communication_window=2, batch_size=16,
               num_epoch=3, learning_rate=0.01, worker_optimizer="adam",
               device="cpu")
    t.train(data)
    h = t.history["round_loss"]
    assert h[-1] < h[0] * 0.9, h


def _criteo_etl(pkg, num_cat=6, buckets=50):
    data = pkg.criteo_synth(2048, num_dense=4, num_categorical=num_cat,
                            vocab_size=100, seed=4)
    etl = Pipeline(
        [MinMaxTransformer("dense")]
        + [HashBucketTransformer(f"c{j}", buckets) for j in range(num_cat)]
        + [AssembleTransformer(
            ["dense"] + [f"c{j}_bucket" for j in range(num_cat)])])
    return etl.fit_transform(data)


def test_criteo_widedeep_end_to_end():
    """BASELINE.md row 5: ETL -> DOWNPOUR -> ModelPredictor ->
    AccuracyEvaluator, at ``tests/test_baseline_configs.py``'s size and
    bars."""
    table = _criteo_etl(datasets)
    assert table["features"].shape == (2048, 10)
    cfg = model_config("wide_deep", (10,), num_dense=4, num_categorical=6,
                       vocab_size=50, embed_dim=8, deep=(32, 16),
                       num_classes=2)
    t = DOWNPOUR(cfg, num_workers=4, communication_window=2,
                 batch_size=32, num_epoch=3, learning_rate=0.01,
                 worker_optimizer="adam", device="cpu")
    variables = t.train(table)
    h = t.history["round_loss"]
    assert h[-1] < h[0] * 0.9, h
    scored = ModelPredictor(t.model, variables, output="class",
                            batch_size=128, device="cpu").predict(table)
    acc = AccuracyEvaluator("prediction", "label").evaluate(scored)
    assert acc > 0.6, acc


def test_widedeep_adag_checkpoint_restores_in_jax(tmp_path):
    """The port's ADAG file of a Wide & Deep run: the JAX trainer's own
    template restores it (the center bit for bit) and trains on from
    it; the port resumes from it as from any other family's."""
    cfg = model_config("wide_deep", (10,), num_dense=4, num_categorical=6,
                       vocab_size=50, embed_dim=8, deep=(32, 16))
    kw = dict(num_workers=2, communication_window=2, batch_size=32,
              learning_rate=0.01, worker_optimizer="adam", seed=0,
              loss="sparse_categorical_crossentropy")
    table = _criteo_etl(datasets).take(512)
    d = tmp_path / "ck"
    first = ADAG(cfg, num_epoch=1, checkpoint_dir=str(d), device="cpu",
                 **kw)
    center = first.train(table)

    jt = jax_trainers.ADAG(cfg, num_epoch=2, **kw)
    got = {}
    orig = jt._maybe_resume

    def resume(resume_from, template):
        state, cursor = orig(resume_from, template)
        got["state"], got["cursor"] = state, dict(cursor)
        return state, cursor

    jt._maybe_resume = resume
    jax_table = _criteo_etl(jax_datasets).take(512)
    jt.train(jax_table, resume_from=str(d))
    assert got["cursor"] == {"epoch": 1, "round": 0}
    restored = convert.params_from_flax(jax.tree_util.tree_map(
        np.asarray, got["state"]["ps"].center))
    assert restored.keys() == center.keys()
    assert all(torch.equal(restored[k], center[k]) for k in center)
    assert np.isfinite(jt.history["epoch_loss"]).all()

    again = ADAG(cfg, num_epoch=2, device="cpu", **kw)
    again.train(table, resume_from=str(d))
    whole = ADAG(cfg, num_epoch=2, device="cpu", **kw)
    whole.train(table)
    assert again.history["round_loss"] == whole.history["round_loss"]
    assert all(torch.equal(again.trained_variables[k],
                           whole.trained_variables[k]) for k in center)


@pytest.mark.parametrize("case", sorted(CASES))
def test_families_cross_the_host_wire(case):
    """One worker over TCP equals the faithful tier bit for bit, as for
    the other families; two workers commit every round."""
    cfg, _ = CASES[case]
    if case == "bilstm":
        data = datasets.imdb_synth(128, seq_len=12, vocab_size=50, seed=1)
    else:
        data = _criteo_etl(datasets).take(128)
        data = data.with_column("features", data["features"])
    kw = dict(communication_window=2, batch_size=8, num_epoch=1,
              learning_rate=0.01, worker_optimizer="adam", seed=0,
              loss="sparse_categorical_crossentropy", device="cpu")
    if case == "wide_deep":
        cfg = model_config("wide_deep", (10,), num_dense=4,
                           num_categorical=6, vocab_size=50, embed_dim=8,
                           deep=(32, 16))
    runs = {fid: ADAG(cfg, num_workers=1, fidelity=fid, **kw)
            for fid in ("host", "faithful")}
    for fid, t in runs.items():
        if fid == "host":
            t.transport = "socket"
        t.train(data)
    assert runs["host"].history["round_loss"] == \
        runs["faithful"].history["round_loss"]
    for k, v in runs["faithful"].trained_variables.items():
        assert torch.equal(runs["host"].trained_variables[k], v), k
    two = ADAG(cfg, num_workers=2, fidelity="host", transport="socket",
               **kw)
    two.train(data)
    assert two.parameter_server_state.num_commits == \
        len(two.history["round_loss"])


def test_port_imports_load_no_jax():
    """``distkeras_tpu_torch.data``, ``.native`` and ``.models`` import
    with ``jax`` and the JAX package blocked."""
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'flax', 'distkeras_tpu'):\n"
            "    sys.modules[m] = None\n"
            "import distkeras_tpu_torch.data, distkeras_tpu_torch.native\n"
            "import distkeras_tpu_torch.models\n"
            "from distkeras_tpu_torch.models import build_model\n"
            "from distkeras_tpu_torch.data import datasets, "
            "HashBucketTransformer\n"
            "build_model(distkeras_tpu_torch.models.model_config("
            "'bilstm', (4,), input_dtype='int32', vocab_size=8, "
            "embed_dim=4, hidden_dim=4), device='cpu')\n"
            "HashBucketTransformer('c0', 5).transform("
            "datasets.criteo_synth(8))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
