"""Trainers of the port: the ``Trainer`` base and ``SingleTrainer``, the
reference's sequential baseline, from ``distkeras_tpu/trainers.py``.

The same front door as the JAX package: a model config (or
``ModelSpec``), a loss and an optimizer by name, a ``Dataset``;
``train()`` returns the trained variables and leaves
``history["epoch_loss"]``/``["segment_stall_s"]`` and
``training_time``.  The port's trained variables are a ``state_dict``
of f32 parameters (``convert.params_to_flax`` maps them to the JAX
package's tree); ``initial_variables`` takes one, e.g. from
``convert.params_from_flax``.

Training runs on ``device`` (default ``cuda``; raises without a card
unless ``device="cpu"``).  The parallel trainers (Sync, the PS family,
Ensemble/Averaging), checkpoints, per-epoch evaluation and profiling are
not ported yet: see ROADMAP.md.
"""

from __future__ import annotations

import time
from typing import Mapping, Sequence

import numpy as np
import torch

from distkeras_tpu_torch import telemetry
from distkeras_tpu_torch.data.dataset import Dataset
from distkeras_tpu_torch.device import resolve_device
from distkeras_tpu_torch.models.core import ModelSpec
from distkeras_tpu_torch.workers import (
    TrainState,
    make_train_step,
    make_window_runner,
    resolve_optimizer,
    single_head,
)


def _unsupported(key: str, item: str):
    return NotImplementedError(
        f"{key} is not ported to distkeras_tpu_torch yet ({item} in "
        "ROADMAP.md)")


def _resolve_spec(model) -> ModelSpec:
    if isinstance(model, ModelSpec):
        return model
    if isinstance(model, Mapping):
        return ModelSpec.from_config(model)
    raise TypeError(
        "model must be a ModelSpec or a model config dict "
        "(distkeras_tpu_torch.models.model_config); got "
        f"{type(model).__name__}")


def _stack_batches(shard: Dataset, batch_size: int,
                   columns: Sequence[str]) -> dict[str, np.ndarray] | None:
    """Rows -> stacked batch arrays ``[num_batches, B, ...]``."""
    n = shard.num_batches(batch_size)
    if n == 0:
        return None
    out = {}
    for c in columns:
        col = shard[c][:n * batch_size]
        out[c] = col.reshape((n, batch_size) + col.shape[1:])
    return out


def _epoch_segments(dataset: Dataset, seed: int):
    """One epoch as in-memory ``Dataset`` segments: the whole set,
    shuffled with ``seed``."""
    if not isinstance(dataset, Dataset):
        raise _unsupported(f"training on a {type(dataset).__name__}",
                           "queue 3b, sharded datasets")
    return [dataset.shuffle(seed=seed)]


class Trainer:
    """Base trainer: owns the model spec, loss, worker optimizer, batch
    size and epoch count (the reference ``Trainer``'s fields), plus the
    trained result and timing."""

    def __init__(self, model, loss: str = "categorical_crossentropy",
                 worker_optimizer="sgd", learning_rate=None,
                 features_col: str = "features", label_col: str = "label",
                 batch_size: int = 32, num_epoch: int = 1, seed: int = 0,
                 checkpoint_dir: str | None = None,
                 profile_dir: str | None = None, device=None):
        """``learning_rate``: float, schedule, or a JSON-friendly
        ``{"schedule": name, **kwargs}`` dict (see
        ``workers.resolve_schedule``).  ``device``: where the model
        trains (default ``cuda``)."""
        if checkpoint_dir is not None:
            raise _unsupported("checkpoint_dir", "queue 3j, checkpoints")
        if profile_dir is not None:
            raise _unsupported("profile_dir", "queue 4b, profiling")
        self.device = resolve_device(device)
        self.spec = _resolve_spec(model)
        self.seed = int(seed)
        self.loss, self.label_col = single_head(loss, label_col)
        # the model's own init is the trainer's default start, drawn
        # from ``seed``
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(self.seed)
            self.model = self.spec.build(device=self.device)
        self.worker_optimizer = worker_optimizer
        self.learning_rate = learning_rate
        self.features_col = features_col
        self.batch_size = int(batch_size)
        self.num_epoch = int(num_epoch)
        self.training_time: float = 0.0
        # ``history`` is a read view over this trainer's own registry
        self.metrics = telemetry.MetricsRegistry()
        self.history = telemetry.HistoryView(self.metrics)
        self.trained_variables: dict | None = None
        #: per-step metrics of the last ``train()`` (``loss``,
        #: ``aux_loss``, ``grad_norm``; numpy, one entry per step),
        #: fetched from the device with the epoch losses
        self.step_metrics: dict[str, np.ndarray] = {}

    def _tx(self):
        return resolve_optimizer(self.worker_optimizer, self.learning_rate)

    def _init_variables(self, initial_variables=None) -> dict:
        """``initial_variables`` (a ``state_dict``), else the model's
        current weights: its init, drawn at construction from ``seed``
        (the bf16 tables and projections start the f32 masters at their
        rounded draws), until a ``train()`` loads the trained ones."""
        if initial_variables is not None:
            return dict(initial_variables)
        return self.model.state_dict()

    def _columns(self) -> list[str]:
        return [self.features_col, self.label_col]

    def _record(self, **kwargs):
        for k, v in kwargs.items():
            self.metrics.series(k).append(v)

    def train(self, dataset: Dataset, initial_variables=None,
              resume_from: str | None = None,
              eval_dataset: Dataset | None = None) -> dict:
        """Train on ``dataset``; returns the trained ``state_dict`` (f32
        parameters), which is also loaded into ``self.model``."""
        if resume_from is not None:
            raise _unsupported("resume_from", "queue 3j, checkpoints")
        if eval_dataset is not None:
            raise _unsupported("eval_dataset",
                               "queue 3j, evaluators and predictors")
        start = time.time()
        try:
            return self._train(dataset, initial_variables)
        finally:
            self.training_time = time.time() - start

    def _train(self, dataset, initial_variables):
        raise NotImplementedError


class SingleTrainer(Trainer):
    """Sequential baseline: one worker, whole dataset (reference
    ``SingleTrainer``).  Steps run from a Python loop over chunks of
    ``SCAN_CHUNK`` batches; each chunk's metrics come to the host once,
    not every step."""

    SCAN_CHUNK = 64  # batches per chunk (host fetch granularity)

    def _train(self, dataset, initial_variables):
        tx = self._tx()
        state = TrainState.create(self.model,
                                  self._init_variables(initial_variables),
                                  tx, device=self.device)
        step = make_train_step(self.model, self.loss, tx,
                               self.features_col, self.label_col)
        run_chunk = make_window_runner(step)
        fetched = []
        for epoch in range(self.num_epoch):
            losses = []
            for segment in _epoch_segments(dataset, self.seed + epoch):
                stacked = _stack_batches(segment, self.batch_size,
                                         self._columns())
                if stacked is None:
                    continue
                n = len(next(iter(stacked.values())))
                for lo in range(0, n, self.SCAN_CHUNK):
                    chunk = {k: torch.from_numpy(
                                 v[lo:lo + self.SCAN_CHUNK]).to(self.device)
                             for k, v in stacked.items()}
                    state, metrics = run_chunk(state, chunk)
                    # one device-to-host copy per chunk
                    host = dict(zip(metrics, torch.stack(
                        list(metrics.values())).cpu().numpy()))
                    losses.append(host["loss"])
                    fetched.append(host)
            if not losses:
                raise ValueError("dataset smaller than one batch")
            # in memory, the segments never keep the step waiting
            self._record(epoch_loss=float(np.concatenate(losses).mean()),
                         segment_stall_s=0.0)
        self.step_metrics = {k: np.concatenate([m[k] for m in fetched])
                             for k in (fetched[0] if fetched else ())}
        self.trained_variables = state.variables()
        self.model.load_state_dict(self.trained_variables)
        return self.trained_variables
