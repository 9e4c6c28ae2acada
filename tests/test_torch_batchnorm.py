"""The port's ``norm="batch"`` ResNet against flax's ``nn.BatchNorm`` in
the JAX package's ResNet, and BatchNorm's running statistics through
the trainers and ``convert``.

Both models get one set of variables (``params`` and ``batch_stats``,
drawn for the port's model and carried over by
``convert.variables_to_flax``) and one numpy input.  The batches are
small (2 images at 16 px: the last stage normalizes 8 values a
channel), where the unbiased variance that ``nn.BatchNorm2d`` would
store is 8/7 of the biased one flax stores, far outside the
tolerances.  f32 throughout: logits within ``TOL`` of their rms, the
statistics within ``STAT_TOL`` (relative, plus the same absolute),
summation order only.  Multi-step training is held as the GroupNorm
ResNet's (``tests/test_torch_ps_trainers.py``): losses within 1e-3,
parameters within 1e-2 of their rms, because XLA's CPU convolutions are
not batching-stable (ROADMAP.md §3)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu import trainers as jax_trainers
from distkeras_tpu.data import datasets as jax_datasets
from distkeras_tpu.models import ModelSpec
from distkeras_tpu.models import model_config as jax_config
from distkeras_tpu_torch import ADAG, SingleTrainer, build_model, convert
from distkeras_tpu_torch.data import datasets
from distkeras_tpu_torch.models import model_config
from distkeras_tpu_torch.models.resnet import _BatchNorm
from distkeras_tpu_torch.workers import (TrainState, make_eval_step,
                                         make_train_step, resolve_optimizer)

jax.config.update("jax_platforms", "cpu")
torch.set_num_threads(1)

TOL, STAT_TOL = 1e-4, 1e-5
SHAPE = (16, 16, 3)
LOSS = "sparse_categorical_crossentropy"


def _resnet(bottleneck):
    return dict(num_classes=4, stage_sizes=(1, 1), bottleneck=bottleneck,
                width=8, norm="batch", dtype="float32")


def _random_variables(model, rng):
    """The port's variables drawn at random: norm scales around 1,
    running means around 0 and variances in [0.5, 1.5], so that eval
    mode reads statistics of its own."""
    sd = {}
    for k, v in model.state_dict().items():
        noise = rng.standard_normal(v.shape).astype(np.float32)
        if k.endswith(".var"):
            noise = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif k.endswith(".mean") or k.endswith(".bias"):
            noise = noise * 0.1
        elif k.endswith(".scale"):
            noise = 1 + 0.3 * noise
        else:
            noise = noise * v.std().item()
        sd[k] = torch.from_numpy(noise)
    return sd


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert np.abs(got - want).max() <= tol * (np.abs(want).max() + 1), (
        what, np.abs(got - want).max())


def test_batch_norm_layer_matches_flax():
    """One layer on ``[2, 1, 2, 3]``: 4 values a channel, so the unbiased
    variance is 4/3 of the biased one.  Train-mode output and updated
    statistics, eval-mode output, and the gradient of the input, scale
    and bias, against ``flax.linen.BatchNorm(momentum=0.9,
    epsilon=1e-5)``; in a bf16 model the statistics stay f32."""
    import flax.linen as fnn

    rng = np.random.default_rng(0)
    x = (3 * rng.standard_normal((2, 1, 2, 3)) + 1).astype(np.float32)
    variables = {
        "params": {"scale": rng.uniform(0.5, 1.5, 3).astype(np.float32),
                   "bias": rng.standard_normal(3).astype(np.float32)},
        "batch_stats": {"mean": rng.standard_normal(3).astype(np.float32),
                        "var": rng.uniform(0.5, 1.5, 3).astype(np.float32)}}
    flax_bn = fnn.BatchNorm(momentum=0.9, epsilon=1e-5)

    def flax_train(params, x):
        y, new = flax_bn.apply({**variables, "params": params}, x,
                               use_running_average=False,
                               mutable=["batch_stats"])
        return y, new["batch_stats"]

    want_y, want_stats = flax_train(variables["params"], x)
    want_eval = flax_bn.apply(variables, x, use_running_average=True)
    want_grads = jax.grad(lambda p, x: flax_train(p, x)[0].sum(),
                          argnums=(0, 1))(variables["params"], x)

    bn = _BatchNorm(3, zero_scale=False)
    bn.load_state_dict({**{k: torch.tensor(v) for k, v in
                           variables["params"].items()},
                        **{k: torch.tensor(v) for k, v in
                           variables["batch_stats"].items()}})
    xt = torch.tensor(x).permute(0, 3, 1, 2).requires_grad_(True)
    with torch.no_grad():
        _close(bn(xt, train=False).permute(0, 2, 3, 1), want_eval, TOL,
               "eval y")
    y = bn(xt, train=True)
    y.sum().backward()
    _close(y.detach().permute(0, 2, 3, 1), want_y, TOL, "train y")
    for k in ("mean", "var"):
        _close(getattr(bn, k), want_stats[k], STAT_TOL, k)
    batch = x.reshape(-1, 3)
    biased, unbiased = batch.var(0), batch.var(0, ddof=1)
    torch_var = 0.9 * variables["batch_stats"]["var"] + 0.1 * unbiased
    assert np.abs(torch_var - np.asarray(want_stats["var"])).min() \
        > 100 * STAT_TOL * (1 + np.abs(biased).max())
    _close(xt.grad.permute(0, 2, 3, 1), want_grads[1], TOL, "dx")
    _close(bn.scale.grad, want_grads[0]["scale"], TOL, "dscale")
    _close(bn.bias.grad, want_grads[0]["bias"], TOL, "dbias")
    bf16 = build_model(model_config("resnet", SHAPE, **{
        **_resnet(False), "dtype": "bfloat16"}), device="cpu")
    assert {b.dtype for b in bf16.buffers()} == {torch.float32}
    assert not any("num_batches_tracked" in k for k in bf16.state_dict())


@pytest.mark.parametrize("bottleneck", [False, True])
def test_resnet_batch_norm_matches_flax(bottleneck):
    """Train-mode logits, eval-mode logits, and the statistics after one
    train step (the port's ``make_train_step``: its model state) against
    flax's ``apply(train=..., mutable=["batch_stats"])`` from the same
    variables; the step's loss too."""
    kw = _resnet(bottleneck)
    port = build_model(model_config("resnet", SHAPE, **kw), device="cpu")
    rng = np.random.default_rng(1)
    sd = _random_variables(port, rng)
    x = rng.standard_normal((2, *SHAPE)).astype(np.float32)
    y = np.array([1, 3], np.int32)
    flax_vars = convert.variables_to_flax(sd)
    assert sorted(flax_vars) == ["batch_stats", "params"]
    model = ModelSpec.from_config(jax_config("resnet", SHAPE, **kw)).build()
    want_train, new = model.apply(flax_vars, x, train=True,
                                  mutable=["batch_stats"])
    want_eval = model.apply(flax_vars, x, train=False)

    port.load_state_dict(sd)
    with torch.no_grad():
        got_eval = port(torch.tensor(x))
        got_train = port(torch.tensor(x), train=True)
    rms = np.sqrt(np.mean(np.asarray(want_train) ** 2))
    assert np.abs(got_train.numpy() - want_train).max() <= TOL * rms
    assert np.abs(got_eval.numpy() - want_eval).max() <= TOL * rms
    # the train-mode forward above updated the module's own buffers:
    # start the step from the drawn ones
    port.load_state_dict(sd)

    tx = resolve_optimizer("sgd", 0.1)
    state = TrainState.create(port, sd, tx)
    before = {k: v.clone() for k, v in state.model_state.items()}
    step = make_train_step(port, LOSS, tx)
    _, metrics = step(state, {"features": torch.tensor(x),
                              "label": torch.tensor(y)})
    want_stats = convert.variables_from_flax(
        {"params": {}, "batch_stats": jax.tree_util.tree_map(
            np.asarray, new["batch_stats"])})
    assert state.model_state.keys() == want_stats.keys()
    for k, want in want_stats.items():
        _close(state.model_state[k], want, STAT_TOL, k)
        assert not torch.equal(state.model_state[k], before[k]), k
    logp = jax.nn.log_softmax(want_train)
    want_loss = -np.mean(np.asarray(logp)[np.arange(2), y])
    assert abs(float(metrics["loss"]) - want_loss) <= TOL * abs(want_loss)


def test_step_writes_the_statistics_back_to_its_own_state():
    """The step takes the updated statistics into the state it ran
    (explicitly: the forward updates a copy), two states made from one
    set of variables share no buffer, and the eval step reads the
    running statistics without moving them."""
    cfg = model_config("resnet", SHAPE, **_resnet(False))
    model = build_model(cfg, device="cpu")
    start = model.state_dict()
    tx = resolve_optimizer("sgd", 0.1)
    a = TrainState.create(model, start, tx)
    b = TrainState.create(model, start, tx)
    assert all(a.model_state[k] is not b.model_state[k]
               and a.model_state[k] is not start[k] for k in start
               if k in a.model_state)
    rng = np.random.default_rng(2)
    batch = {"features": torch.tensor(rng.standard_normal(
                 (2, *SHAPE)).astype(np.float32)),
             "label": torch.tensor([0, 1])}
    old = dict(a.model_state)
    make_train_step(model, LOSS, tx)(a, batch)
    moved = [k for k in old if not torch.equal(a.model_state[k], old[k])]
    assert moved == list(old)
    # the tensors handed in were the state's own copies, left unchanged
    assert all(torch.equal(old[k], b.model_state[k]) for k in old)
    assert all(torch.equal(start[k], b.model_state[k]) for k in old)
    stats = {k: v.clone() for k, v in a.model_state.items()}
    ev = make_eval_step(model, LOSS)(a.variables(), batch)
    assert all(torch.equal(a.model_state[k], stats[k]) for k in stats)
    model.load_state_dict(a.variables())
    with torch.no_grad():
        assert torch.equal(ev["logits"], model(batch["features"]))


def _jax_start(kw, seed=0):
    model = ModelSpec.from_config(jax_config("resnet", SHAPE, **kw)).build()
    return model.init(jax.random.key(seed), jnp.zeros((2, *SHAPE)))


def _assert_trained_close(pv, jv):
    want = convert.variables_from_flax(jax.tree_util.tree_map(np.asarray,
                                                              jv))
    assert pv.keys() == want.keys()
    for k in want:
        rms = want[k].square().mean().sqrt().item()
        assert (pv[k] - want[k]).abs().max().item() <= 1e-2 * rms + 1e-6, k


def _trainer_pair(name, bottleneck, stages, **train):
    """The JAX and the port's trainer ``name`` on one tiny ``norm="batch"``
    ResNet from the JAX init (``params`` and ``batch_stats``) on the same
    32 rows; the port's PS commit orders are the JAX trainer's."""
    kw = {**_resnet(bottleneck), "stage_sizes": stages}
    start = _jax_start(kw)
    train = dict(num_epoch=1, learning_rate=0.02, seed=0,
                 worker_optimizer="momentum", loss=LOSS, **train)
    jt = getattr(jax_trainers, name)(jax_config("resnet", SHAPE, **kw),
                                     **train)
    jv = jt.train(jax_datasets.synthetic_classification(32, SHAPE, 4,
                                                        seed=4),
                  initial_variables=start)
    pt = globals()[name](model_config("resnet", SHAPE, **kw), device="cpu",
                         **train)
    if "num_workers" in train:
        key, orders = jax.random.key(train["seed"] + 2), []
        for _ in jt.history["round_loss"]:
            key, sub = jax.random.split(key)
            orders.append(np.asarray(jax.random.permutation(
                sub, train["num_workers"])).tolist())
        pt.commit_orders = lambda: iter(orders)
    pv = pt.train(datasets.synthetic_classification(32, SHAPE, 4, seed=4),
                  initial_variables=convert.variables_from_flax(
                      jax.tree_util.tree_map(np.asarray, start)))
    return jt, jv, pt, pv


def test_single_trainer_batch_norm_matches_jax():
    """4 steps of momentum SGD: the losses within 1e-3, the parameters
    and the returned statistics within 1e-2 of their rms."""
    jt, jv, pt, pv = _trainer_pair("SingleTrainer", False, (1,),
                                   batch_size=8)
    np.testing.assert_allclose(pt.history["epoch_loss"],
                               jt.history["epoch_loss"], atol=1e-3)
    _assert_trained_close(pv, jv)


def test_adag_keeps_batch_norm_statistics_per_worker():
    """ADAG, faithful, 2 workers, 2 rounds: round losses within 1e-3 of
    the JAX trainer's; the returned statistics are worker 0's (the JAX
    trainer's, within 1e-2 of their rms); the two workers' statistics
    differ; the center holds parameters only."""
    jt, jv, pt, pv = _trainer_pair("ADAG", False, (1,), num_workers=2,
                                   communication_window=2, batch_size=4,
                                   lr_law="off")
    np.testing.assert_allclose(pt.history["round_loss"],
                               jt.history["round_loss"], atol=1e-3)
    _assert_trained_close(pv, jv)
    w0, w1 = pt.worker_model_states
    assert all(torch.equal(pv[k], w0[k]) for k in w0)
    assert all(not torch.equal(w0[k], w1[k]) for k in w0)
    params = {n for n, _ in pt.model.named_parameters()}
    assert set(pt.parameter_server_state.center) == params
    assert set(pv) == params | set(w0)


def test_adag_bottleneck_round_matches_the_jax_steps():
    """A bottleneck ResNet through ADAG: the first round's loss (each
    worker's window from the shared start) equals the JAX package's own
    ``make_train_step`` run worker by worker, within 1e-5.  The JAX
    ADAG trainer itself is not the reference here: on the 8-device CPU
    mesh of ``tests/conftest.py`` its round losses for this model stand
    5 % off those steps (1.5000 against 1.4268), while on one CPU device
    they equal the port's (ROADMAP.md §3)."""
    from distkeras_tpu import workers as jax_workers

    kw = _resnet(True)
    start = _jax_start(kw)
    rows = jax_datasets.synthetic_classification(32, SHAPE, 4, seed=4)
    tx = jax_workers.resolve_optimizer("momentum", 0.02)
    step = jax.jit(jax_workers.make_train_step(model=ModelSpec.from_config(
        jax_config("resnet", SHAPE, **kw)).build(), loss=LOSS, tx=tx))
    losses = []
    for shard in rows.shuffle(0).repartition(2):
        state = jax_workers.TrainState.create(start, tx, jax.random.key(1))
        for b in range(2):
            state, m = step(state, {k: shard[k][4 * b:4 * (b + 1)]
                                    for k in ("features", "label")})
            losses.append(float(m["loss"]))
    pt = ADAG(model_config("resnet", SHAPE, **kw), device="cpu",
              num_workers=2, communication_window=2, batch_size=4,
              num_epoch=1, learning_rate=0.02, lr_law="off", seed=0,
              worker_optimizer="momentum", loss=LOSS)
    pt.train(datasets.synthetic_classification(32, SHAPE, 4, seed=4),
             initial_variables=convert.variables_from_flax(
                 jax.tree_util.tree_map(np.asarray, start)))
    assert abs(pt.history["round_loss"][0] - np.mean(losses)) <= 1e-5


def test_convert_carries_batch_stats_both_ways():
    """The port's tree maps onto flax's init, ``params`` and
    ``batch_stats`` path for path and shape for shape, and back without
    loss; ``params_to_flax`` leaves the statistics out."""
    kw = _resnet(True)
    sd = build_model(model_config("resnet", SHAPE, **kw),
                     device="cpu").state_dict()
    tree = convert.variables_to_flax(sd)

    def shapes(t):
        return {jax.tree_util.keystr(p): np.shape(x)
                for p, x in jax.tree_util.tree_leaves_with_path(t)}

    assert shapes(tree) == shapes(_jax_start(kw))
    assert shapes(convert.params_to_flax(sd)) == shapes(tree["params"])
    back = convert.variables_from_flax(tree)
    assert back.keys() == sd.keys()
    assert all(torch.equal(back[k], sd[k]) for k in sd)
