"""Worker machinery: the training step, the window runner and the
optimizer and schedule tables; the port of ``distkeras_tpu/workers.py``.

Optimizers follow optax's formulas and defaults, not ``torch.optim``'s
(they differ: optax's RMSprop puts eps inside the square root and
decays by 0.9, its Adagrad starts the accumulator at 0.1 with eps
1e-7, its AdamW decays weights by 1e-4).  Each is a pair of plain
functions on dicts of f32 tensors, like optax's
``GradientTransformation`` with ``apply_updates`` folded in: where optax
returns new trees, the port updates the parameters and the optimizer
state IN PLACE, which saves a copy of each per step.

The parameters a step updates are f32 master copies
(``TrainState.params``), as flax's are; the forward casts them to the
module's own dtypes (bf16 for the LM's projections and tables), so
autograd through the cast hands back f32 gradients, as flax's cast
does.
"""

from __future__ import annotations

import dataclasses
import math
import numbers
from typing import Any, Callable, Mapping, NamedTuple

import numpy as np
import torch
from torch.func import functional_call

from distkeras_tpu_torch.ops.losses import resolve_loss

Params = dict[str, torch.Tensor]


class Optimizer(NamedTuple):
    """``init(params) -> state``; ``update(grads, state, params)``
    applies one step to ``params`` and ``state`` in place.  ``chain``:
    optax's state layout of the same optimizer, the slots of each
    transformation of its chain in order (``("count", "mu", "nu")`` for
    ``scale_by_adam``, ``("count",)`` for a scheduled rate, ``()`` for
    a stateless one); ``convert.train_state_to_flax`` writes the state
    in it."""

    init: Callable[[Params], dict]
    update: Callable[[Params, dict, Params], None]
    chain: tuple = ()


def _zeros(params: Params) -> Params:
    return {n: torch.zeros_like(p) for n, p in params.items()}


def _full(params: Params, value: float) -> Params:
    return {n: torch.full_like(p, value) for n, p in params.items()}


def _bias_correction(decay: float, count: int) -> float:
    """optax's ``1 - decay ** count``, taken in f32 as optax takes it."""
    return float(np.float32(1) - np.float32(decay) ** np.float32(count))


#: in an optimizer's chain: ``scale_by_learning_rate``, whose state is
#: the update count under a schedule and empty under a constant rate
RATE = "rate"


def _optimizer(lr, slots: Callable[[Params], dict],
               direction: Callable[..., torch.Tensor],
               chain: tuple) -> Optimizer:
    """A chain ``direction`` then ``scale_by_learning_rate(lr)``:
    ``direction(name, grad, param, state, count)`` returns the update
    before the rate (``count`` is the 1-based step) and advances its
    own slots in place.  ``chain``: optax's layout, ``RATE`` where the
    rate's transformation sits."""
    schedule = lr if callable(lr) else (lambda count: lr)
    chain = tuple((("count",) if callable(lr) else ()) if t == RATE else t
                  for t in chain)

    def init(params: Params) -> dict:
        return {"count": 0, **slots(params)}

    @torch.no_grad()
    def update(grads: Params, state: dict, params: Params) -> None:
        step = -float(schedule(state["count"]))
        state["count"] += 1
        for n, p in params.items():
            u = direction(n, grads[n], p, state, state["count"])
            p.add_(u * step)

    return Optimizer(init, update, chain)


def sgd(lr=0.01, momentum: float | None = None,
        nesterov: bool = False) -> Optimizer:
    """optax.sgd: ``trace`` (``t = g + m t``; Nesterov ``g + m t``) when
    ``momentum`` is set."""
    def slots(params):
        return {"trace": _zeros(params) if momentum else None}

    def direction(n, g, p, state, count):
        if not momentum:
            return g
        t = state["trace"][n].mul_(momentum).add_(g)
        return g + momentum * t if nesterov else t

    return _optimizer(lr, slots, direction,
                      (("trace",) if momentum else (), RATE))


def adam(lr=0.001, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Optimizer:
    """optax.adam: bias-corrected moments, ``m / (sqrt(v) + eps)``."""
    return _adam(lr, b1, b2, eps, 0.0)


def adamw(lr=0.001, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 1e-4) -> Optimizer:
    """optax.adamw: Adam's direction plus ``weight_decay * param``,
    both scaled by the rate."""
    return _adam(lr, b1, b2, eps, weight_decay)


def _adam(lr, b1, b2, eps, weight_decay) -> Optimizer:
    def slots(params):
        return {"mu": _zeros(params), "nu": _zeros(params)}

    def direction(n, g, p, state, count):
        mu = state["mu"][n].mul_(b1).add_(g * (1 - b1))
        nu = state["nu"][n].mul_(b2).add_(g * g * (1 - b2))
        mu_hat = mu / _bias_correction(b1, count)
        nu_hat = nu / _bias_correction(b2, count)
        u = mu_hat / (torch.sqrt(nu_hat) + eps)
        return u + weight_decay * p if weight_decay else u

    adam_state = ("count", "mu", "nu")
    return _optimizer(lr, slots, direction,
                      (adam_state, (), RATE) if weight_decay
                      else (adam_state, RATE))


def adagrad(lr=0.01, initial_accumulator_value: float = 0.1,
            eps: float = 1e-7) -> Optimizer:
    """optax.adagrad: ``g / sqrt(sum g^2 + eps)``, the sum starting at
    ``initial_accumulator_value``."""
    def slots(params):
        return {"sum_of_squares": _full(params, initial_accumulator_value)}

    def direction(n, g, p, state, count):
        s = state["sum_of_squares"][n].add_(g * g)
        return torch.where(s > 0, torch.rsqrt(s + eps), 0.0) * g

    return _optimizer(lr, slots, direction, (("sum_of_squares",), RATE))


def rmsprop(lr=0.001, decay: float = 0.9, eps: float = 1e-8) -> Optimizer:
    """optax.rmsprop (not centered, no momentum): ``g / sqrt(v + eps)``
    with eps inside the root."""
    def slots(params):
        return {"nu": _zeros(params)}

    def direction(n, g, p, state, count):
        nu = state["nu"][n].mul_(decay).add_(g * g * (1 - decay))
        return torch.rsqrt(nu + eps) * g

    # optax.rmsprop: scale_by_rms, the rate, then momentum's trace or
    # (here) identity
    return _optimizer(lr, slots, direction, (("nu",), RATE, ()))


OPTIMIZERS: dict[str, Callable[..., Optimizer]] = {
    "sgd": lambda lr=0.01, **kw: sgd(lr, **kw),
    "momentum": lambda lr=0.01, m=0.9, **kw: sgd(lr, momentum=m, **kw),
    "nesterov": lambda lr=0.01, m=0.9, **kw: sgd(
        lr, momentum=m, nesterov=True, **kw),
    "adam": lambda lr=0.001, **kw: adam(lr, **kw),
    "adagrad": lambda lr=0.01, **kw: adagrad(lr, **kw),
    "rmsprop": lambda lr=0.001, **kw: rmsprop(lr, **kw),
    "adamw": lambda lr=0.001, **kw: adamw(lr, **kw),
}


# -- schedules: functions of the 0-based update count, optax's formulas --


def constant_schedule(value):
    return lambda count: value


def _linear_schedule(init_value, end_value, transition_steps):
    if transition_steps <= 0:
        return lambda count: init_value

    def schedule(count):
        frac = 1 - min(max(count, 0), transition_steps) / transition_steps
        return (init_value - end_value) * frac + end_value

    return schedule


def cosine_decay_schedule(init_value, decay_steps, alpha=0.0,
                          exponent=1.0):
    if not decay_steps > 0:
        raise ValueError(f"cosine_decay_schedule needs positive "
                         f"decay_steps, got {decay_steps}")

    def schedule(count):
        cosine = 0.5 * (1 + math.cos(math.pi * min(count, decay_steps)
                                     / decay_steps))
        return init_value * ((1 - alpha) * cosine ** exponent + alpha)

    return schedule


def exponential_decay(init_value, transition_steps, decay_rate,
                      transition_begin=0, staircase=False, end_value=None):
    if transition_steps <= 0 or decay_rate == 0:
        return lambda count: init_value
    transition_begin = max(transition_begin, 0)
    clip = max if decay_rate < 1.0 else min

    def schedule(count):
        passed = count - transition_begin
        p = passed / transition_steps
        if staircase:
            p = math.floor(p)
        value = init_value if passed <= 0 else init_value * decay_rate ** p
        return value if end_value is None else clip(value, end_value)

    return schedule


def warmup_cosine_decay_schedule(init_value, peak_value, warmup_steps,
                                 decay_steps, end_value=0.0, exponent=1.0):
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    warm = _linear_schedule(init_value, peak_value, warmup_steps)
    decay = cosine_decay_schedule(peak_value, decay_steps - warmup_steps,
                                  alpha, exponent)
    return lambda count: (warm(count) if count < warmup_steps
                          else decay(count - warmup_steps))


def piecewise_constant_schedule(init_value, boundaries_and_scales=None):
    items = sorted((boundaries_and_scales or {}).items())
    if any(scale < 0 for _, scale in items):
        raise ValueError("piecewise_constant_schedule expects "
                         "non-negative scale factors")

    def schedule(count):
        value = init_value
        for threshold, scale in items:
            if count >= threshold:
                value *= scale
        return value

    return schedule


SCHEDULES: dict[str, Callable[..., Any]] = {
    "constant": constant_schedule,
    "cosine": cosine_decay_schedule,
    "exponential": exponential_decay,
    "warmup_cosine": warmup_cosine_decay_schedule,
    "piecewise_constant": lambda init_value, boundaries_and_scales:
        piecewise_constant_schedule(
            init_value, {int(k): float(v)
                         for k, v in boundaries_and_scales.items()}),
}


def resolve_schedule(spec):
    """Learning-rate spec -> a float or a function of the update count.

    ``spec`` may be a number (constant), a callable (a schedule, passed
    through), a 0-d array or tensor, or a JSON-friendly dict
    ``{"schedule": <name>, **kwargs}`` with optax's own kwarg names,
    e.g. ``{"schedule": "cosine", "init_value": 0.1, "decay_steps":
    1000}``.  Schedules advance with the optimizer's update count.
    """
    if spec is None or isinstance(spec, numbers.Real) or callable(spec):
        return spec
    if getattr(spec, "ndim", None) == 0:
        return float(spec)
    if isinstance(spec, Mapping):
        kwargs = dict(spec)
        name = kwargs.pop("schedule", None)
        if name not in SCHEDULES:
            raise KeyError(f"unknown schedule {name!r}; known: "
                           f"{sorted(SCHEDULES)}")
        return SCHEDULES[name](**kwargs)
    raise TypeError(f"cannot resolve a learning rate from {type(spec)}")


def resolve_optimizer(optimizer, learning_rate=None, **kwargs) -> Optimizer:
    """String name / ``Optimizer`` -> ``Optimizer``.  ``learning_rate``
    accepts anything ``resolve_schedule`` does."""
    if isinstance(optimizer, Optimizer):
        return optimizer
    if isinstance(optimizer, str):
        if optimizer not in OPTIMIZERS:
            raise KeyError(f"unknown optimizer {optimizer!r}; known: "
                           f"{sorted(OPTIMIZERS)}")
        if learning_rate is not None:
            kwargs["lr"] = resolve_schedule(learning_rate)
        return OPTIMIZERS[optimizer](**kwargs)
    raise TypeError(f"cannot resolve optimizer from {type(optimizer)}")


# -- train state, step, window runner ---------------------------------


def rng_stream(seed: int, *path: int, device=None) -> torch.Generator:
    """A random stream on ``device``: a ``torch.Generator`` seeded from
    ``seed`` and the integers ``path``, the port's ``key(seed)`` (no
    path) and ``fold_in``/``split`` (a path per worker or member).
    Distinct paths give unrelated streams (numpy's ``SeedSequence``
    with ``path`` as its spawn key); the draws differ from
    ``jax.random``'s."""
    words = np.random.SeedSequence(seed, spawn_key=path).generate_state(
        2, np.uint32)
    return torch.Generator(device=device).manual_seed(
        (int(words[0]) << 31) ^ int(words[1]))


@dataclasses.dataclass
class TrainState:
    """Training state: the step count, f32 master ``params`` (leaf
    tensors that require grad), the optimizer state, ``model_state``
    (the module's buffers: BatchNorm's running statistics, f32; none for
    the LM) and ``rng``, the state's own random stream (a
    ``torch.Generator`` on its device; dropout draws its masks from it).

    ``model_state`` and ``rng`` stay this state's own: the PS trainers
    exchange ``params`` only (``adopt``), as the reference's rules do."""

    step: int
    params: Params
    opt_state: dict
    model_state: Params
    rng: torch.Generator | None = None

    @classmethod
    def create(cls, model: torch.nn.Module, variables: Mapping,
               optimizer: Optimizer, device=None,
               rng: torch.Generator | None = None) -> "TrainState":
        """``variables``: a ``state_dict`` of ``model`` (any dtype, any
        device); parameters are copied to f32 on ``device``, buffers
        (those ``variables`` lacks from ``model``) are copied in their
        own dtype, so no two states share a tensor.  ``rng``: the
        state's stream (``rng_stream``); a model that draws (dropout in
        train mode) raises without one."""
        names = [n for n, _ in model.named_parameters()]
        missing = [n for n in names if n not in variables]
        if missing:
            raise KeyError(f"variables lack parameters {missing}")
        params = {n: torch.as_tensor(variables[n]).detach().to(
                      device=device, dtype=torch.float32, copy=True)
                  .requires_grad_(True) for n in names}
        model_state = {n: torch.as_tensor(variables.get(n, b)).detach().to(
                           device=device, dtype=b.dtype, copy=True)
                       for n, b in model.named_buffers()}
        return cls(step=0, params=params, opt_state=optimizer.init(params),
                   model_state=model_state, rng=rng)

    def adopt(self, params: Mapping[str, torch.Tensor]) -> None:
        """Take the values of ``params`` (a pulled PS center) into this
        state's parameters, in place, keeping the optimizer state, the
        model state and the stream: the PS round's
        ``worker_states.replace(params=pulled)``.  The leaves stay this
        state's own, so the center is never aliased."""
        with torch.no_grad():
            for n, p in self.params.items():
                p.copy_(params[n])

    def variables(self) -> Params:
        """The ``state_dict``: f32 parameters and the buffers."""
        return {**{n: p.detach() for n, p in self.params.items()},
                **self.model_state}


def _module_variables(model, variables: Mapping) -> dict:
    """``variables`` cast to the dtype of each of ``model``'s own
    tensors: the f32 master parameters meet the module's compute dtype
    here, differentiably."""
    own = dict(model.named_parameters())
    own.update(model.named_buffers())
    return {n: v.to(own[n].dtype) for n, v in variables.items()}


def single_head(loss, label_col):
    """``(loss, label_col)`` of a single-head model, unwrapping the
    length-1 sequence spelling; a loss and a label column per head (a
    multi-output model) raises."""
    seqs = [isinstance(x, (list, tuple)) for x in (loss, label_col)]
    if any(seqs):
        if not (all(seqs) and len(loss) == 1 and len(label_col) == 1):
            raise NotImplementedError(
                "multi-output models (a loss and a label column per "
                "head) are not ported to distkeras_tpu_torch yet "
                "(ROADMAP.md §1 item 10)")
        loss, label_col = loss[0], label_col[0]
    return loss, label_col


def make_train_step(model, loss, optimizer: Optimizer,
                    features_col: str = "features",
                    label_col: str = "label"):
    """Build ``step(state, batch) -> (state, metrics)``.  The step
    updates ``state`` in place and returns it; ``metrics`` are device
    scalars: ``loss``, ``aux_loss`` (0: no ported model sows an
    auxiliary loss) and ``grad_norm`` (the global norm of the f32
    gradients, as ``optax.global_norm``).

    The forward runs in train mode (``train=True``, flax's
    ``apply(..., train=True)``) and draws its dropout masks from
    ``state.rng``.  A train-mode BatchNorm updates the running
    statistics it is handed in place, as ``nn.BatchNorm`` does; the step
    hands it a copy of ``state.model_state`` and takes that copy in as
    the new ``model_state`` (flax's ``mutable=["batch_stats"]``)."""
    loss, label_col = single_head(loss, label_col)
    loss_fn = resolve_loss(loss)

    def step(state: TrainState, batch: Mapping[str, torch.Tensor]):
        model_state = {n: b.clone() for n, b in state.model_state.items()}
        variables = {**_module_variables(model, state.params),
                     **model_state}
        logits = functional_call(model, variables, (batch[features_col],),
                                 {"train": True, "rng": state.rng})
        state.model_state = model_state
        task_loss = loss_fn(logits, batch[label_col])
        grads = dict(zip(state.params, torch.autograd.grad(
            task_loss, list(state.params.values()))))
        grad_norm = torch.stack([g.square().sum()
                                 for g in grads.values()]).sum().sqrt()
        # a profiler range (free when no profiler runs): the optimizer's
        # share of a step's device time
        with torch.profiler.record_function("optimizer_update"):
            optimizer.update(grads, state.opt_state, state.params)
        state.step += 1
        metrics = {"loss": task_loss.detach(),
                   "aux_loss": torch.zeros((), device=task_loss.device),
                   "grad_norm": grad_norm}
        return state, metrics

    return step


def make_window_runner(step_fn):
    """``run(state, batches) -> (state, metrics)``: ``step_fn`` over a
    stacked window of batches (leaves ``[window, B, ...]``), a Python
    loop in place of ``lax.scan``; metrics come back stacked
    ``[window]`` and stay on the device."""

    def run(state: TrainState, batches: Mapping[str, torch.Tensor]):
        n = len(next(iter(batches.values())))
        steps = []
        for i in range(n):
            state, metrics = step_fn(state, {k: v[i]
                                             for k, v in batches.items()})
            steps.append(metrics)
        return state, {k: torch.stack([m[k] for m in steps])
                       for k in steps[0]}

    return run


def make_eval_step(model, loss, features_col: str = "features",
                   label_col: str = "label"):
    """Build ``eval_step(variables, batch) -> {"loss", "logits"}``
    (no gradients; ``variables`` a ``state_dict`` in any dtype).  The
    forward runs in eval mode: no dropout, BatchNorm on its running
    statistics, nothing updated."""
    loss, label_col = single_head(loss, label_col)
    loss_fn = resolve_loss(loss)

    @torch.no_grad()
    def eval_step(variables, batch):
        logits = functional_call(model, _module_variables(model, variables),
                                 (batch[features_col],), {"train": False})
        return {"loss": loss_fn(logits, batch[label_col]),
                "logits": logits}

    return eval_step
