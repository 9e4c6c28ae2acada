"""Trainers of the port, from ``distkeras_tpu/trainers.py``: the
``Trainer`` base, ``SingleTrainer`` (the sequential baseline),
``SyncTrainer`` (synchronous data parallelism), the parameter-server
family and the member trainers (``EnsembleTrainer``,
``AveragingTrainer``).

The same front door as the JAX package: a model config (or
``ModelSpec``), a loss and an optimizer by name, a ``Dataset`` or an
out-of-core ``ShardedDataset`` (npz or CSV shard files, mapped through
ETL or not; ``data/sharded.py``), streamed one shard at a time, the
next one loaded ahead on a thread (``DKT_SEGMENT_PREFETCH``, default
1); ``train()`` returns the trained variables and leaves
``history["epoch_loss"]``, ``["segment_stall_s"]`` (the seconds the
loop waited for its segments) and ``training_time``.  The port's
trained variables are a ``state_dict`` of f32 parameters
(``convert.params_to_flax`` maps them to the JAX package's tree);
``initial_variables`` takes one, e.g. from ``convert.params_from_flax``.

Training runs on ``device`` (default ``cuda``; raises without a card
unless ``device="cpu"``).

The PS family (``DOWNPOUR``, ``ADAG``, ``DynSGD``, ``AEASGD``,
``EAMSGD``) trains on the emulated tiers (``fidelity="faithful"`` or
``"fast"``, ``commit_overlap``, ``lr_law``), following the JAX loop's
data path: each epoch's plan from ``seed + 17 * epoch`` (the shuffled
set, or the shard files in a permuted order, rows shuffled per shard),
each segment ``repartition(num_workers)``, each worker's rows stacked
into batches, ``[W, window, B, ...]`` per round, rounds numbered across
the epoch's segments, one commit order per round from
``commit_orders`` (seeded from ``seed + 2``).

Every training state carries its own random stream (``TrainState.rng``,
dropout's masks), seeded as the reference keys its states: ``seed + 1``
for Single and Sync, one stream per PS worker and per member split from
it.  Its model state (BatchNorm's running statistics) stays its own:
the PS rules exchange parameters only.

``checkpoint_dir`` saves the training state at every epoch boundary
(and, for the PS family, every ``checkpoint_every_rounds`` rounds) in
the JAX package's file format (``checkpoint.py``), and
``train(resume_from=...)`` continues a killed run from such a file: the
resumed run repeats the uninterrupted one bit for bit, since every
random source (the shuffles, the commit orders, each state's stream) is
keyed by saved state.  ``train(eval_dataset=...)`` records
``history["eval_accuracy"]`` once per epoch.  ``fidelity="host"`` runs
the PS family as free-running worker threads against a parameter
server on the host (``parallel.host_ps``), over direct calls or TCP, on
the JAX package's wire.  The mesh tier, SyncTrainer's tensor and
pipeline parallelism, the replicated, elastic and hierarchical PS arms
and profiling are not ported yet: see ROADMAP.md §1.
"""

from __future__ import annotations

import copy
import os
import queue
import threading
import time
from pathlib import Path
from typing import ClassVar, Mapping, Sequence

import numpy as np
import torch

from distkeras_tpu_torch import (checkpoint, convert, serialization,
                                 telemetry)
from distkeras_tpu_torch.data.dataset import Dataset
from distkeras_tpu_torch.data.sharded import ShardedDataset
from distkeras_tpu_torch.device import resolve_device
from distkeras_tpu_torch.models.core import ModelSpec
from distkeras_tpu_torch.parallel import ps_emulator
from distkeras_tpu_torch.parallel.tiers import resolve_tier, tiers_with
from distkeras_tpu_torch.parallel.update_rules import (
    AdagRule,
    DownpourRule,
    DynSGDRule,
    ElasticRule,
    UpdateRule,
)
from distkeras_tpu_torch.workers import (
    TrainState,
    make_train_step,
    make_window_runner,
    resolve_optimizer,
    rng_stream,
    single_head,
)


def _unsupported(key: str, item: int):
    return NotImplementedError(
        f"{key} is not ported to distkeras_tpu_torch yet (ROADMAP.md §1 "
        f"item {item})")


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


def _prefetch_depth() -> int:
    """Segments to load ahead of the consumer (0 disables), from
    ``DKT_SEGMENT_PREFETCH`` (default 1), the JAX package's variable:
    prefetch never changes results, only timing."""
    return int(os.environ.get("DKT_SEGMENT_PREFETCH", "1"))


def _prefetch_iter(it, depth: int | None = None):
    """Iterate ``it`` on a daemon thread, keeping up to ``depth`` items
    built ahead of the consumer: segment IO (read, parse, shuffle)
    overlaps the training on the previous segment.  Order-preserving;
    the iterator's exceptions raise again at the consumer's ``next``;
    closing the generator cancels the feeder."""
    if depth is None:
        depth = _prefetch_depth()
    if depth <= 0:
        yield from it
        return
    done = object()
    q: queue.Queue = queue.Queue()
    # build tickets: the feeder may hold ``depth`` items beyond the one
    # the consumer is on; released as the consumer moves on
    slots = threading.Semaphore(depth + 1)
    # set when the consumer abandons the generator mid-epoch: the feeder
    # exits instead of blocking in ``slots.acquire()`` holding segments
    cancelled = threading.Event()

    def feed():
        try:
            while True:
                slots.acquire()
                if cancelled.is_set():
                    return
                try:
                    item = next(it)
                except StopIteration:
                    q.put(done)
                    return
                q.put((item,))
        except BaseException as exc:  # raised on the consumer's side
            q.put(exc)
            q.put(done)

    threading.Thread(target=feed, daemon=True,
                     name="dkt-segment-prefetch").start()
    try:
        while True:
            got = q.get()
            if got is done:
                return
            if isinstance(got, BaseException):
                raise got
            yield got[0]
            slots.release()
    finally:
        cancelled.set()
        slots.release()  # wake a feeder blocked on its ticket


def _epoch_segments(dataset, seed: int, stall: list | None = None):
    """One epoch as in-memory ``Dataset`` segments: an in-memory set
    gives one, the whole set shuffled with ``seed``; a
    ``ShardedDataset`` streams its shard files in the seed-permuted
    order, rows shuffled per shard, loaded ahead by ``_prefetch_iter``.
    ``stall`` (a one-element list) adds up the seconds the consumer
    waited for segments."""
    if isinstance(dataset, ShardedDataset):
        it = _prefetch_iter(dataset.epoch_segments(seed))
    else:
        it = iter([dataset.shuffle(seed=seed)])
    if stall is None:
        return it

    def timed():
        while True:
            t0 = telemetry.now()
            try:
                item = next(it)
            except StopIteration:
                return
            stall[0] += telemetry.now() - t0
            yield item
    return timed()


class _SegmentPrefetch:
    """One-deep background segment load for the plan-driven PS loop,
    which decides skips from metadata before it touches a file.
    ``queue(key, load)`` starts ``load()`` on a daemon thread;
    ``get(key, load)`` joins and returns it, or loads synchronously on a
    key mismatch (a wrong lookahead costs the overlap, never the
    result).  Load errors raise again in ``get``."""

    def __init__(self):
        self._key = None
        self._thread: threading.Thread | None = None
        self._box: dict | None = None

    def queue(self, key, load):
        box: dict = {}

        def run():
            try:
                box["value"] = load()
            except BaseException as exc:
                box["error"] = exc

        t = threading.Thread(target=run, daemon=True,
                             name="dkt-segment-prefetch")
        t.start()
        self._key, self._thread, self._box = key, t, box

    def get(self, key, load):
        if self._thread is not None and self._key == key:
            self._thread.join()
            box = self._box
            self._key = self._thread = self._box = None
            if "error" in box:
                raise box["error"]
            return box["value"]
        return load()


def _epoch_segment_loaders(dataset, seed: int):
    """``_epoch_segments`` with the data deferred: ``(rows, load)``
    pairs, so a resuming PS trainer skips whole shard files it has
    consumed from their metadata alone."""
    if isinstance(dataset, ShardedDataset):
        return dataset.epoch_segment_loaders(seed)
    return iter([(len(dataset), lambda: dataset.shuffle(seed=seed))])


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
        ``workers.resolve_schedule``).  ``checkpoint_dir``: where the
        epoch-boundary checkpoints go (a directory, or an explicit
        ``.msgpack`` file).  ``device``: where the model trains (default
        ``cuda``)."""
        if profile_dir is not None:
            raise _unsupported("profile_dir", 8)
        self.device = resolve_device(device)
        self.spec = _resolve_spec(model)
        self.seed = int(seed)
        self.loss, self.label_col = single_head(loss, label_col)
        # the model's own init is the trainer's default start, drawn
        # from ``seed``
        self.model = self._build_seeded(self.seed)
        self.worker_optimizer = worker_optimizer
        self.learning_rate = learning_rate
        self.features_col = features_col
        self.batch_size = int(batch_size)
        self.num_epoch = int(num_epoch)
        self.checkpoint_dir = checkpoint_dir
        self.training_time: float = 0.0
        # ``history`` is a read view over this trainer's own registry
        self.metrics = telemetry.MetricsRegistry()
        self.history = telemetry.HistoryView(self.metrics)
        self.trained_variables: dict | None = None
        #: per-step metrics of the last ``train()`` (``loss``,
        #: ``aux_loss``, ``grad_norm``; numpy, one entry per step),
        #: fetched from the device with the epoch losses
        self.step_metrics: dict[str, np.ndarray] = {}

    def _build_seeded(self, seed: int) -> torch.nn.Module:
        """The model, its init drawn from torch's generator seeded with
        ``seed`` (the global one, forked: the caller's draws are
        untouched)."""
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            return self.spec.build(device=self.device)

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
        parameters), which is also loaded into ``self.model``.
        ``resume_from`` continues from a checkpoint written with
        ``checkpoint_dir`` set (same configuration and dataset: the
        same result as the uninterrupted run); a JAX-written checkpoint
        of the same model and optimizer restores too.  ``eval_dataset``
        records ``history["eval_accuracy"]`` at every epoch's end."""
        self._eval_dataset = eval_dataset
        self._eval_predictor = None
        start = time.time()
        try:
            return self._train(dataset, initial_variables, resume_from)
        finally:
            self.training_time = time.time() - start

    def _train(self, dataset, initial_variables, resume_from=None):
        raise NotImplementedError

    def _eval_epoch(self, variables) -> None:
        """Epoch-boundary hook: accuracy on ``eval_dataset`` when set,
        through one ``ModelPredictor`` (batch ``max(batch_size, 256)``)
        kept across epochs; only its variables change."""
        if self._eval_dataset is None:
            return
        from distkeras_tpu_torch.evaluators import metrics_from_logits
        from distkeras_tpu_torch.predictors import ModelPredictor

        if self._eval_predictor is None:
            self._eval_predictor = ModelPredictor(
                self.model, variables, features_col=self.features_col,
                output="logits", batch_size=max(self.batch_size, 256))
        else:
            self._eval_predictor.variables = variables
        scored = self._eval_predictor.predict(self._eval_dataset)
        m = metrics_from_logits(scored["prediction"],
                                self._eval_dataset[self.label_col])
        self._record(eval_accuracy=m["accuracy"])

    # -- checkpoint plumbing ----------------------------------------------

    def _num_heads(self) -> int | None:
        """The LM's head count, which its flax layout needs."""
        return self.spec.kwargs.get("num_heads")

    def _maybe_save(self, state, cursor: dict) -> None:
        """Write ``state`` (the trainer's live state, see
        ``_to_checkpoint``) with ``cursor`` and the full history, when
        ``checkpoint_dir`` is set."""
        if self.checkpoint_dir is None:
            return
        tree, streams = self._to_checkpoint(state)
        # the cursor is JSON: materialize the registry view
        checkpoint.save_checkpoint(
            self.checkpoint_dir, tree,
            {**cursor, "history": dict(self.history)}, streams)
        if checkpoint.has_sharded(self.checkpoint_dir):
            # one layout per directory: a stale sharded checkpoint would
            # shadow this newer file at the next resume
            import shutil

            shutil.rmtree(Path(self.checkpoint_dir) / checkpoint.SHARDED,
                          ignore_errors=True)

    def _restore_history(self, cursor: dict) -> dict:
        """Pop the checkpointed history into the registry-backed view
        (the view object stays; its backing series are reset)."""
        self.history.replace({
            k: list(v) for k, v in cursor.pop("history", {}).items()})
        return cursor

    def _maybe_resume(self, resume_from, state):
        """``(state, cursor)``: ``state`` restored from ``resume_from``,
        or as given with an empty cursor when not resuming."""
        if resume_from is None:
            return state, {}
        if checkpoint.has_sharded(resume_from):
            raise _unsupported(
                f"resuming from the sharded (orbax) checkpoint in "
                f"{resume_from!r}", _MESH_TIER)
        tree, cursor, streams = checkpoint.load_checkpoint(
            resume_from, streams=True)
        cursor = self._restore_history(cursor)
        return self._from_checkpoint(state, tree, streams), cursor

    def _to_checkpoint(self, state) -> tuple[dict, dict]:
        """``(state dict in the JAX layout, the port's stream entry)``
        of one ``TrainState``."""
        tree = convert.train_state_to_flax(state, self._tx().chain,
                                           self._num_heads())
        return tree, {"rng": _stream_state(state.rng)}

    def _from_checkpoint(self, state, tree, streams):
        convert.train_state_from_flax(tree, state, self._tx().chain)
        _restore_stream(state, None if streams is None else streams["rng"],
                        tree["rng"])
        return state


def _stream_state(gen: torch.Generator | None):
    return None if gen is None else gen.get_state().numpy()


def _restore_stream(state: TrainState, saved, key) -> None:
    """The stream's exact state where the file has it (a port-written
    file), else a stream seeded from the key leaf (a JAX-written one)."""
    if saved is not None:
        state.rng.set_state(torch.from_numpy(np.array(saved, np.uint8)))
    elif state.rng is not None:
        state.rng = convert.stream_from_key(key, state.rng.device)


def _clone_tree(x):
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, dict):
        return {k: _clone_tree(v) for k, v in x.items()}
    return x


def _snapshot_state(state: TrainState):
    """What a retried window must start from: the step, optimizer state,
    model state and stream position before the window."""
    return (state.step, _clone_tree(state.opt_state),
            _clone_tree(state.model_state),
            None if state.rng is None else state.rng.get_state())


def _restore_state(state: TrainState, snap) -> None:
    step, opt, model_state, rng = snap
    state.step = step
    state.opt_state = _clone_tree(opt)
    state.model_state = _clone_tree(model_state)
    if rng is not None:
        state.rng.set_state(rng)


class SingleTrainer(Trainer):
    """Sequential baseline: one worker, whole dataset (reference
    ``SingleTrainer``).  Steps run from a Python loop over chunks of
    ``SCAN_CHUNK`` batches; each chunk's metrics come to the host once,
    not every step.  The state's stream is seeded with ``seed + 1``.
    Checkpoints at every epoch's end; a resume starts at the cursor's
    epoch (``step_metrics`` then holds the resumed epochs' steps)."""

    SCAN_CHUNK = 64  # batches per chunk (host fetch granularity)

    def _global_batch(self) -> int:
        """Rows per step."""
        return self.batch_size

    def _train(self, dataset, initial_variables, resume_from=None):
        tx = self._tx()
        state = TrainState.create(self.model,
                                  self._init_variables(initial_variables),
                                  tx, device=self.device,
                                  rng=rng_stream(self.seed + 1,
                                                 device=self.device))
        state, cursor = self._maybe_resume(resume_from, state)
        global_batch = self._global_batch()
        step = make_train_step(self.model, self.loss, tx,
                               self.features_col, self.label_col)
        run_chunk = make_window_runner(step)
        fetched = []
        for epoch in range(int(cursor.get("epoch", 0)), self.num_epoch):
            losses = []
            stall = [0.0]
            for segment in _epoch_segments(dataset, self.seed + epoch,
                                           stall):
                stacked = _stack_batches(segment, global_batch,
                                         self._columns())
                if stacked is None:
                    # a shard smaller than one global batch: dropped as
                    # any tail remainder (the check below keeps a whole
                    # epoch from passing so)
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
                raise ValueError(f"dataset smaller than one batch "
                                 f"({global_batch} rows)")
            self._record(epoch_loss=float(np.concatenate(losses).mean()),
                         segment_stall_s=round(stall[0], 4))
            self._eval_epoch(state.variables())
            self._maybe_save(state, {"epoch": epoch + 1})
        self.step_metrics = {k: np.concatenate([m[k] for m in fetched])
                             for k in (fetched[0] if fetched else ())}
        self.trained_variables = state.variables()
        self.model.load_state_dict(self.trained_variables)
        return self.trained_variables


class SyncTrainer(SingleTrainer):
    """Synchronous data parallelism (reference ``SyncTrainer``, its
    data-parallel arm, ``_train_dp``): one step over the global batch of
    ``batch_size * num_workers`` rows, each epoch shuffled with ``seed +
    epoch``.  The reference shards that batch across a mesh of workers
    and all-reduces the gradients; the port runs it whole on its one
    device, the same mean gradient, so it equals ``SingleTrainer`` at
    ``batch_size * num_workers`` step for step.  ``num_workers=None``
    means 1 (the one device).  Not in the original dist-keras: it is the
    convergence control arm of the async family.  History:
    ``epoch_loss``, ``segment_stall_s``.

    ``model_parallel > 1``, ``tp_rules`` and ``pipeline_stages > 1``
    (tensor and pipeline parallelism) raise ``NotImplementedError``;
    values the reference refuses raise its ``ValueError``."""

    SCAN_CHUNK = 32

    def __init__(self, model, num_workers: int | None = None,
                 model_parallel: int = 1, tp_rules=None,
                 pipeline_stages: int = 1,
                 pipeline_microbatches: int | None = None, **kwargs):
        super().__init__(model, **kwargs)
        self.num_workers = int(num_workers or 1)
        if self.num_workers < 1:
            raise ValueError(
                f"num_workers must be >= 1, got {num_workers}")
        self.model_parallel = int(model_parallel)
        if self.model_parallel < 1:
            raise ValueError(
                f"model_parallel must be >= 1, got {model_parallel}")
        self.tp_rules = tp_rules
        self.pipeline_stages = int(pipeline_stages)
        if self.pipeline_stages < 1:
            raise ValueError(
                f"pipeline_stages must be >= 1, got {pipeline_stages}")
        if self.pipeline_stages > 1 and self.model_parallel > 1:
            raise ValueError(
                "pipeline_stages and model_parallel are mutually "
                "exclusive (pp x tp composition is not implemented)")
        self.pipeline_microbatches = (
            None if pipeline_microbatches is None
            else int(pipeline_microbatches))
        if self.model_parallel > 1:
            raise _unsupported("model_parallel > 1", 9)
        if tp_rules is not None:
            raise _unsupported("tp_rules", 9)
        if self.pipeline_stages > 1:
            raise _unsupported("pipeline_stages > 1", 9)

    def _global_batch(self) -> int:
        return self.batch_size * self.num_workers


# the JAX DistributedTrainer's keyword arguments of tiers and layers the
# port does not have yet, with their defaults and ROADMAP.md §1 items
_MESH_TIER = 8
_ROBUSTNESS = 10
_UNPORTED_KWARGS = {
    "ps_replicas": (None, _ROBUSTNESS),
    "ps_elastic": (False, _ROBUSTNESS),
    "ps_groups": (None, _ROBUSTNESS),
    "comm_dtype": ("float32", _MESH_TIER),
    "comm_codec": (None, _MESH_TIER),
    "metrics_every": (1, _MESH_TIER),
    "attrib_every": (0, _MESH_TIER),
    "tp_rules": (None, 9),
}


class DistributedTrainer(Trainer):
    """Base of the async PS family (reference ``DistributedTrainer``):
    ``num_workers`` workers of ``communication_window`` local steps per
    emulated commit round.  ``fidelity``: ``"faithful"`` (commits applied
    one by one) or ``"fast"`` (closed form); ``commit_overlap=True`` runs
    the faithful tier's commits one round behind the windows
    (``ps_emulator.make_pipelined_round_fn``).  ``lr_law``: ``"warn"``
    (default) warns where the learning rate times the family's
    amplification passes the measured stability scale, ``"scale"``
    divides the rate by the family's measured divisor, ``"off"``.

    Each worker keeps its own model state (BatchNorm's running
    statistics) and its own random stream (``rng_stream(seed + 1,
    w)``): the rules exchange parameters only.  ``train()`` returns the
    center's parameters (f32) with worker 0's model state, as the
    reference does, also kept as ``trained_variables`` and loaded into
    ``self.model``; the center is in ``parameter_server_state`` and each
    worker's final model state in ``worker_model_states``; history:
    ``round_loss``, ``staleness`` (per round, each worker's commit
    position), ``dropped_tail_batches``, ``epoch_loss``,
    ``segment_stall_s``, and ``skipped_segment_rows`` for each shard too
    small to give every worker a batch.  The next segment loads on a
    thread while the current one trains.  ``epoch_time_s``: each
    epoch's wall seconds, from its plan to its last round's metrics on
    the host.

    ``fidelity="host"`` runs the reference's own design: free-running
    worker threads (each with its own copy of the model, all on the
    trainer's device) against a concurrent parameter server on the host
    (``parallel.host_ps``), whose center is the flax ``params`` tree of
    numpy leaves, the JAX package's wire layout: ``transport=
    "inprocess"`` (direct calls) or ``"socket"`` (TCP, a server the
    trainer starts, or an external one at ``ps_address``).  Staleness
    emerges from the races.  Its keywords are the JAX trainer's:
    ``compression`` (delta family; error feedback on the worker),
    ``commit_overlap`` (delta family; each exchange runs under the next
    window), ``worker_retries``, ``max_worker_failures``,
    ``worker_timeout`` (a watchdog records silent workers),
    ``fault_injector(worker, epoch, round)``, ``ps_address``,
    ``ps_shards`` (``parallel.sharded_ps``), ``ps_snapshot_path`` and
    ``ps_snapshot_every``.  History: ``round_loss`` (in completion
    order), ``staleness`` (the server's log), ``epoch_loss``,
    ``dropped_tail_batches``, ``slo_health`` and, by arm,
    ``worker_failures``, ``worker_round_retries``,
    ``detected_idle_workers``, ``ps_snapshots``, ``commit_wire_bytes``/
    ``commit_raw_bytes``, ``pull_shards_skipped``/``pull_bytes_saved``.
    ``train()`` returns the center with the initial model state (the
    JAX host arm's result); ``parameter_server_state`` is the server
    (None for an external one).  ``ps_replicas``, ``ps_elastic`` and
    ``ps_groups`` raise (ROADMAP.md §1 item 10), as does a run in more
    than one process (item 8).

    With ``checkpoint_dir``, the state is saved at every epoch's end and,
    with ``checkpoint_every_rounds=r``, after every r-th round inside an
    epoch, rounds counted across the epoch's segments (a save due at a
    segment's last round is made there where a later segment of the
    epoch has rounds, read off the plan's row counts, and one due at the
    epoch's last round is the epoch-end save).  The JAX trainer makes
    such a save at the next segment's start, after that segment's
    ``dropped_tail_batches`` record, which its resume then records
    again; the port's saves are at the same cursors, and its resumes
    repeat the uninterrupted history.
    The file holds the center, the commit clock and every worker's state
    on a leading worker axis; the port's entry adds each worker's stream
    and the number of commit orders drawn, so a resume skips that many
    draws of ``commit_orders()`` (a replaced sequence resumes too).  A
    mid-epoch resume skips the epoch's done rounds, and the shard files
    they consumed unread, and takes their losses from the restored
    history.  ``commit_overlap`` cannot checkpoint: its
    center is always one round behind."""

    #: effective per-round lr (configured lr x family amplification)
    #: above which the staleness families measurably degrade on the JAX
    #: package's calibration task (PARITY.md): a heuristic guardrail
    _LR_LAW_EFFECTIVE_MAX = 0.1

    def __init__(self, model, num_workers: int = 2,
                 communication_window: int = 5,
                 fidelity: str = "faithful", transport: str = "inprocess",
                 checkpoint_every_rounds: int | None = None,
                 max_worker_failures: int = 0, worker_retries: int = 0,
                 worker_timeout: float | None = None,
                 fault_injector=None, compression=None,
                 model_parallel: int = 1, lr_law: str = "warn",
                 commit_overlap: bool = False,
                 ps_address: tuple[str, int] | None = None,
                 ps_shards: int = 1, ps_snapshot_path: str | None = None,
                 ps_snapshot_every: int = 0, **kwargs):
        for key, (default, item) in _UNPORTED_KWARGS.items():
            if key in kwargs and kwargs.pop(key) != default:
                raise _unsupported(key, item)
        super().__init__(model, **kwargs)
        self.num_workers = int(num_workers)
        self.communication_window = int(communication_window)
        self.checkpoint_every_rounds = checkpoint_every_rounds
        self.tier = resolve_tier(fidelity)
        self.fidelity = fidelity
        self._check_checkpoint_tier(self.checkpoint_dir)
        if self.tier.data_plane == "mesh":
            raise _unsupported(f"fidelity={fidelity!r}", _MESH_TIER)
        if int(model_parallel) != 1:
            raise _unsupported("model_parallel > 1", 9)
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized() \
                and dist.get_world_size() > 1:
            raise _unsupported("multi-host PS training", _MESH_TIER)
        self.transport = transport
        self.max_worker_failures = int(max_worker_failures)
        self.worker_retries = int(worker_retries)
        self.fault_injector = fault_injector
        self.worker_timeout = (None if worker_timeout is None
                               else float(worker_timeout))
        self.compression = compression
        if compression is not None:
            from distkeras_tpu_torch.parallel.compression import (
                resolve_codec)

            resolve_codec(compression)  # fail fast on a bad spec
        if self.worker_timeout is not None and self.worker_timeout <= 0:
            raise ValueError(
                f"worker_timeout must be positive, got {worker_timeout}")
        self.ps_address = (None if ps_address is None
                           else (str(ps_address[0]), int(ps_address[1])))
        self.ps_shards = int(ps_shards)
        if self.ps_shards < 1:
            raise ValueError(f"ps_shards must be >= 1, got {ps_shards}")
        self.ps_snapshot_path = ps_snapshot_path
        self.ps_snapshot_every = int(ps_snapshot_every)
        if not self.tier.concurrent and (
                self.max_worker_failures or self.worker_retries
                or self.worker_timeout is not None
                or fault_injector is not None or compression is not None
                or ps_address is not None or self.ps_shards > 1
                or ps_snapshot_path is not None or self.ps_snapshot_every):
            raise ValueError(
                "max_worker_failures / worker_retries / worker_timeout "
                "/ fault_injector / compression / ps_address / "
                "ps_replicas / ps_shards / ps_groups / ps_snapshot_* "
                "apply only to "
                "fidelity='host' (the compiled tiers are "
                "deterministic; recover via checkpoint/resume), got "
                f"fidelity={fidelity!r}; concurrent tiers: "
                f"{tiers_with('concurrent')}")
        if ps_address is not None and transport != "socket":
            raise ValueError(
                "ps_address attaches to an external PSServer over TCP; "
                f"it requires transport='socket', got {transport!r}")
        if self.ps_snapshot_every and ps_snapshot_path is None:
            raise ValueError(
                "ps_snapshot_every needs ps_snapshot_path to write to")
        if ps_address is not None and (ps_snapshot_path is not None
                                       or self.ps_snapshot_every):
            raise ValueError(
                "with an external ps_address, configure snapshotting "
                "on the externally created HostParameterServer, not "
                "on the trainer (the trainer does not own the server)")
        self.commit_overlap = bool(commit_overlap)
        if self.commit_overlap and not self.tier.commit_overlap:
            raise ValueError(
                "commit_overlap pipelines the commit against the next "
                "window; it needs a tier with a separate commit phase "
                "— the fast arm's closed form has none, got "
                f"fidelity={fidelity!r}; overlap-capable tiers: "
                f"{tiers_with('commit_overlap')}")
        if self.commit_overlap and (checkpoint_every_rounds
                                    or self.checkpoint_dir):
            raise ValueError(
                "commit_overlap runs one commit round behind — "
                "mid-training checkpoints would snapshot a center "
                "missing the pending round; train without "
                "checkpointing or without commit_overlap")
        if lr_law not in ("warn", "scale", "off"):
            raise ValueError(
                f"lr_law={lr_law!r} must be 'warn' (default: warn "
                "when the configured lr violates the measured "
                "per-family stability law), 'scale' (divide lr by "
                "the family's amplification factor), or 'off'")
        self.lr_law = lr_law
        self._apply_lr_law()
        self.parameter_server_state = None
        self.worker_model_states: list[dict] = []
        self.epoch_time_s: list[float] = []

    def _check_checkpoint_tier(self, wanted) -> None:
        """The reference's guard: a tier that cannot checkpoint refuses
        ``checkpoint_dir`` and ``resume_from``."""
        if self.tier.checkpoint or not wanted:
            return
        if self.tier.name == "host":
            raise NotImplementedError(
                "fidelity='host' is the nondeterministic faithful arm; "
                "checkpoint/resume of racing threads is not supported — "
                "use the emulated fidelities")
        raise NotImplementedError(
            f"fidelity={self.tier.name!r} does not checkpoint its "
            f"sharded-center layout; checkpointing tiers: "
            f"{tiers_with('checkpoint')}")

    def commit_orders(self):
        """The rounds' commit orders, one per round across all epochs,
        from a generator seeded with ``seed + 2`` (the JAX trainer draws
        its own from ``jax.random.key(seed + 2)``).  Replace this method
        on an instance to impose another sequence."""
        return ps_emulator.commit_permutations(self.seed + 2,
                                               self.num_workers)

    def _lr_law(self):
        """``(amplification, scale_divisor, law)`` for this family, or
        ``None`` (the JAX trainer's table: DOWNPOUR x workers*window,
        ADAG x workers, DynSGD x window, EAMSGD ~1/(1-m) with the
        measured divisor 2; the elastic exchange itself is lr-neutral)."""
        return None

    def _apply_lr_law(self) -> None:
        law = self._lr_law()
        if law is None or self.lr_law == "off":
            return
        factor, divisor, suggestion = law
        try:
            lr = float(self.learning_rate)
        except (TypeError, ValueError):
            return  # schedules: the law is about constant-lr configs
        if self.lr_law == "scale":
            self.learning_rate = lr / divisor
            return
        effective = lr * factor
        if effective > self._LR_LAW_EFFECTIVE_MAX:
            import warnings

            warnings.warn(
                f"{type(self).__name__}: learning_rate={lr:g} is "
                f"amplified ~{factor:g}x per PS round by this "
                f"family's update law (effective {effective:g} > "
                f"{self._LR_LAW_EFFECTIVE_MAX} — the measured "
                "stability scale; PARITY.md 'per-family learning-"
                f"rate scaling laws').  Consider {suggestion}, pass "
                "lr_law='scale' to apply it automatically, or "
                "lr_law='off' if this lr is deliberate.",
                UserWarning, stacklevel=3)

    def allocate_rule(self) -> UpdateRule:
        raise NotImplementedError

    def _to_checkpoint(self, state) -> tuple[dict, dict]:
        """``state``: ``{"ps", "workers", "orders"}``, the PS state, the
        workers' ``TrainState``s and the commit orders drawn.  The
        file's ``perm_key`` holds the commit-order stream's seed.  The
        tree comes to the host in one copy, and the workers are stacked
        there, so a save takes no memory on the card."""
        chain, heads = self._tx().chain, self._num_heads()
        ps_state, workers = state["ps"], state["workers"]
        tree = serialization.to_host({
            "perm_key": convert.seed_key(self.seed + 2),
            "ps": {"center": convert.params_tree(ps_state.center, heads),
                   "clock": np.asarray(int(ps_state.clock), np.int32)},
            "workers": [convert.train_state_to_flax(w, chain, heads)
                        for w in workers]})
        tree["workers"] = convert.stack_trees(tree["workers"])
        return tree, {"rng": [_stream_state(w.rng) for w in workers],
                      "commit_orders": state["orders"]}

    def _from_checkpoint(self, state, tree, streams):
        chain = self._tx().chain
        ps_state = state["ps"]
        with torch.no_grad():
            for n, v in convert.params_from_flax(
                    tree["ps"]["center"]).items():
                ps_state.center[n].copy_(v)
        workers = tree["workers"]
        for w, ws in enumerate(state["workers"]):
            one = convert.index_tree(workers, w)
            convert.train_state_from_flax(one, ws, chain)
            _restore_stream(ws, None if streams is None
                            else streams["rng"][str(w)], one["rng"])
        # a JAX-written file: one order was drawn per recorded round
        orders = (streams["commit_orders"] if streams is not None
                  else len(self.history.get("round_loss", [])))
        return {"ps": ps_state._replace(clock=int(tree["ps"]["clock"])),
                "workers": state["workers"], "orders": int(orders)}

    def _train(self, dataset, initial_variables, resume_from=None):
        self._check_checkpoint_tier(resume_from)
        if self.tier.data_plane == "host-wire":
            return self._train_host(dataset, initial_variables)
        rule = self.allocate_rule()
        tx = self._tx()
        variables = self._init_variables(initial_variables)
        num_workers, window = self.num_workers, self.communication_window
        names = [n for n, _ in self.model.named_parameters()]
        center = {n: torch.as_tensor(variables[n]).detach().to(
                      device=self.device, dtype=torch.float32, copy=True)
                  for n in names}
        workers = [TrainState.create(self.model, variables, tx,
                                     device=self.device,
                                     rng=rng_stream(self.seed + 1, w,
                                                    device=self.device))
                   for w in range(num_workers)]
        step = make_train_step(self.model, self.loss, tx,
                               self.features_col, self.label_col)
        overlap = self.commit_overlap
        if overlap:
            round_fn = ps_emulator.make_pipelined_round_fn(rule, step)
        else:
            round_fn = ps_emulator.make_round_fn(rule, step, self.fidelity)
        live, cursor = self._maybe_resume(
            resume_from, {"ps": rule.init_state(center), "workers": workers,
                          "orders": 0})
        ps_state, drawn = live["ps"], live["orders"]
        orders = self.commit_orders()
        for _ in range(drawn):   # the orders of the rounds already done
            next(orders)
        start_epoch = int(cursor.get("epoch", 0))
        start_round = int(cursor.get("round", 0))
        cols = self._columns()
        # the pipelined round's pending commit, until the first round
        pend, pend_perm, pend_valid = None, list(range(num_workers)), False
        self.epoch_time_s = []

        def predicted_rounds(rows: int) -> int:
            # repartition + _stack_batches + // window, from a row count
            if rows < num_workers:
                return 0
            return ((rows // num_workers) // self.batch_size) // window

        for epoch in range(start_epoch, self.num_epoch):
            t_epoch = time.monotonic()
            first_round = start_round if epoch == start_epoch else 0
            # a mid-epoch resume: the done rounds' losses are in the
            # restored history, and their records are not made again
            epoch_losses: list[float] = list(
                self.history.get("round_loss", [])[-first_round:]) \
                if first_round else []
            pending = None  # the previous round's device metrics

            def drain(metrics):
                round_loss = float(np.mean(metrics["loss"].cpu().numpy()))
                epoch_losses.append(round_loss)
                self._record(round_loss=round_loss,
                             staleness=metrics["staleness"].tolist())

            def save_point(point: dict) -> None:
                # every recorded round is in the history before it saves
                nonlocal pending
                if pending is not None:
                    drain(pending)
                    pending = None
                self._maybe_save({"ps": ps_state, "workers": workers,
                                  "orders": drawn}, point)

            # rounds are numbered across the epoch's segments (one for
            # in-memory data, one per shard file otherwise), as the
            # checkpoint cursor counts them
            round_base = 0
            plan = list(_epoch_segment_loaders(dataset,
                                               self.seed + 17 * epoch))
            # whether a segment after j has rounds: a save due at a
            # segment's last round is made only where the epoch goes on
            # (the epoch-end save stands for it otherwise)
            later = [predicted_rounds(rows) for rows, _ in plan]
            goes_on = [any(later[j + 1:]) for j in range(len(plan))]
            prefetch = _SegmentPrefetch()
            seg_stall = 0.0

            def next_loadable(j: int, rb: int) -> int | None:
                # this loop's skip rules replayed on metadata: the
                # segment after j that will load (a wrong answer costs
                # only the overlap)
                rb += predicted_rounds(plan[j][0])
                for k in range(j + 1, len(plan)):
                    hint = predicted_rounds(plan[k][0])
                    if rb + hint <= first_round and hint > 0:
                        rb += hint
                        continue
                    if plan[k][0] < num_workers:
                        continue
                    return k
                return None

            for seg_j, (seg_rows, load_segment) in enumerate(plan):
                sr_hint = predicted_rounds(seg_rows)
                if round_base + sr_hint <= first_round and sr_hint > 0:
                    # every round of this segment predates the resume
                    # point: the file is not read
                    round_base += sr_hint
                    continue
                # a segment entered before a mid-epoch stop has its
                # records in the restored history
                record_this_segment = round_base >= first_round
                if seg_rows < num_workers:
                    # too few rows to give every worker one: dropped,
                    # recorded, the file not read
                    if record_this_segment:
                        self._record(skipped_segment_rows=seg_rows)
                    continue
                t_get = telemetry.now()
                segment = prefetch.get(seg_j, load_segment)
                seg_stall += telemetry.now() - t_get
                if _prefetch_depth() > 0:
                    nxt = next_loadable(seg_j, round_base)
                    if nxt is not None:
                        prefetch.queue(nxt, plan[nxt][1])
                per_worker = [_stack_batches(shard, self.batch_size, cols)
                              for shard in segment.repartition(num_workers)]
                if any(p is None for p in per_worker):
                    # smaller than one batch a worker
                    if record_this_segment:
                        self._record(skipped_segment_rows=seg_rows)
                    continue
                n_batches = min(len(next(iter(p.values())))
                                for p in per_worker)
                seg_rounds = n_batches // window
                if record_this_segment:
                    # tail batches that do not fill a window are dropped,
                    # and counted
                    self._record(dropped_tail_batches=n_batches
                                 - seg_rounds * window)
                for r_local in range(seg_rounds):
                    r = round_base + r_local
                    if r < first_round:
                        continue  # a resume: the round is in the file
                    perm = next(orders)
                    drawn += 1
                    batch = {k: torch.from_numpy(np.stack(
                                 [p[k][r_local * window:
                                       (r_local + 1) * window]
                                  for p in per_worker])).to(self.device)
                             for k in cols}
                    if overlap:
                        (ps_state, workers, metrics, pend, pend_perm,
                         pend_valid) = round_fn(ps_state, workers, batch,
                                                perm, pend, pend_perm,
                                                pend_valid)
                    else:
                        ps_state, workers, metrics = round_fn(
                            ps_state, workers, batch, perm)
                    # metrics come to the host one round late, so the
                    # host assembles the next round while this one runs
                    if pending is not None:
                        drain(pending)
                    pending = metrics
                    every = self.checkpoint_every_rounds
                    if every and (r + 1) % every == 0 and (
                            r_local + 1 < seg_rounds or goes_on[seg_j]):
                        # at a segment's end the save comes before the
                        # next segments' records, so a resume from it
                        # makes each record once
                        save_point({"epoch": epoch, "round": r + 1})
                round_base += seg_rounds
            if round_base == 0:
                raise ValueError(
                    f"not enough batches per worker for one "
                    f"communication window ({window}) in any segment")
            if pending is not None:
                drain(pending)
                pending = None
            if overlap and pend_valid:
                # the pipeline runs one commit behind: fold the final
                # pending round in so the returned center has every commit
                ps_state = ps_emulator.flush_pending(
                    rule, ps_state, pend, pend_perm, num_workers)
                pend_valid = False
            self.epoch_time_s.append(time.monotonic() - t_epoch)
            self._record(epoch_loss=float(np.mean(epoch_losses)),
                         segment_stall_s=round(seg_stall, 4))
            self._eval_epoch({**ps_state.center, **workers[0].model_state})
            save_point({"epoch": epoch + 1, "round": 0})
        self.parameter_server_state = ps_state
        self.worker_model_states = [w.model_state for w in workers]
        self.trained_variables = {**ps_state.center,
                                  **workers[0].model_state}
        self.model.load_state_dict(self.trained_variables)
        return self.trained_variables

    # -- the host arm ------------------------------------------------------

    def _train_host(self, dataset, initial_variables):
        """Design 5a (SURVEY.md §7): free-running worker threads against
        a concurrent host-side parameter server, the JAX package's
        ``_train_host`` (one process).  Each worker thread trains its
        own copy of the model on the trainer's device, on the device's
        current stream; between windows it turns its parameters into the
        flax tree on the device, copies it to the host once (waiting on
        an event, not the device) and exchanges it with the server,
        whose center is that tree of numpy leaves."""
        from concurrent.futures import ThreadPoolExecutor

        from distkeras_tpu_torch import flight_recorder
        from distkeras_tpu_torch.analysis import racecheck
        from distkeras_tpu_torch.parallel.compression import (raw_nbytes,
                                                              resolve_codec)
        from distkeras_tpu_torch.parallel.host_ps import (
            HostParameterServer, PSClient, PSRetryExhausted, PSServer,
            ResilientPSClient)
        from distkeras_tpu_torch.parallel.trees import tree_map

        rule = self.allocate_rule()
        codec = resolve_codec(self.compression)
        if codec is not None and rule.payload_kind != "delta":
            raise ValueError(
                "compression applies only to the delta-family rules "
                "(DOWNPOUR/ADAG/DynSGD): their additive payloads are "
                "error-feedback-correctable; the elastic family "
                "commits absolute parameters")
        if self.commit_overlap and rule.payload_kind != "delta":
            raise ValueError(
                "commit_overlap on the host arm supports the delta "
                "family only (the elastic exchange folds the pulled "
                "center back into the worker's CURRENT locals — "
                "nothing to overlap)")
        if self.transport not in ("inprocess", "socket"):
            raise ValueError(
                f"unknown transport {self.transport!r}; "
                "expected 'inprocess' or 'socket'")
        tx = self._tx()
        variables = self._init_variables(initial_variables)
        heads = self._num_heads()
        names = [n for n, _ in self.model.named_parameters()]
        # the wire's tree: flax layout, f32 numpy leaves
        center = serialization.to_host(convert.params_tree(
            {n: variables[n] for n in names}, heads))
        model_state = {n: torch.as_tensor(variables.get(n, b)).detach().to(
                           device=self.device, dtype=b.dtype, copy=True)
                       for n, b in self.model.named_buffers()}
        num_workers = self.num_workers
        window = self.communication_window

        shard_plan = None
        if self.ps_shards > 1:
            from distkeras_tpu_torch.parallel.sharded_ps import plan_shards

            # the one plan every endpoint derives from (template, K)
            shard_plan = plan_shards(center, self.ps_shards)

        ps = None
        server = None
        if self.ps_address is None:
            if self.ps_shards > 1:
                from distkeras_tpu_torch.parallel.sharded_ps import (
                    ShardedParameterServer)

                ps = ShardedParameterServer(
                    rule, center, self.ps_shards,
                    snapshot_path=self.ps_snapshot_path,
                    snapshot_every=self.ps_snapshot_every)
            else:
                ps = HostParameterServer(
                    rule, center, snapshot_path=self.ps_snapshot_path,
                    snapshot_every=self.ps_snapshot_every)
            if self.transport == "socket":
                server = PSServer(ps, center, host="127.0.0.1").start()
        ps_address = (self.ps_address if self.ps_address is not None
                      else server.address if server is not None else None)

        # every worker thread its own module: ``functional_call`` swaps
        # a module's tensors for the duration of a forward
        models = [self.model] + [copy.deepcopy(self.model)
                                 for _ in range(num_workers - 1)]
        cols = self._columns()
        round_records = telemetry.Series()  # (worker, epoch, loss)
        retry_records = telemetry.Series()  # (worker, epoch, round)
        failures = telemetry.Series()       # (worker, exception)
        wire_total = telemetry.Counter()    # codec-arm commit bytes
        raw_total = telemetry.Counter()
        skip_total = telemetry.Counter()    # version-delta pull savings
        saved_total = telemetry.Counter()   # (sharded socket arm)

        # each segment's load, shuffle and repartition, keyed (epoch,
        # segment slot): one segment for in-memory data, one per shard
        # file otherwise.  The first worker to reach a segment builds it
        # (others wait on its event) and starts the next one's build in
        # the background; a failed build poisons its entry, so every
        # worker raises instead of hanging; an entry goes once every live
        # worker has fetched it, so host memory holds the segments in
        # flight.  RLock: ``segment_shard`` -> ``epoch_plan`` nests.
        shard_lock = racecheck.rlock("trainers.shard")
        # entry: (shards | None | exception, fetched, event, ready)
        shard_cache: dict[tuple[int, int], tuple] = {}
        plan_cache: dict[int, list] = {}
        dead_workers: set[int] = set()
        dropped_per_epoch = [0] * self.num_epoch
        skipped_rows_per_epoch = [0] * self.num_epoch
        accum_lock = racecheck.lock("trainers.accum")

        def _sweep_shard_cache():
            # caller holds shard_lock
            for key in [key for key, (_, fetched, _, ready)
                        in shard_cache.items()
                        if ready and fetched | dead_workers
                        >= set(range(num_workers))]:
                del shard_cache[key]

        def epoch_plan(epoch: int) -> list:
            # (rows, load) pairs: every worker walks the same order
            with shard_lock:
                if epoch not in plan_cache:
                    plan_cache[epoch] = list(_epoch_segment_loaders(
                        dataset, self.seed + 17 * epoch))
                return plan_cache[epoch]

        def build_segment(key: tuple[int, int], event: threading.Event):
            """Load, shuffle and repartition segment ``key`` and publish
            it; a failure poisons the entry before the event fires."""
            epoch, slot = key
            shards: object = None
            try:
                rows, load = epoch_plan(epoch)[slot]
                shards = (load().repartition(num_workers)
                          if rows >= num_workers else None)
            except BaseException as exc:
                shards = exc
                raise
            finally:
                with shard_lock:
                    shard_cache[key] = (shards, set(), event, True)
                event.set()

        def prefetch_segment(epoch: int, slot: int):
            """The one-ahead build, through the same publish path."""
            key = (epoch, slot)
            with shard_lock:
                if key in shard_cache:
                    return
                event = threading.Event()
                shard_cache[key] = (None, set(), event, False)
            try:
                build_segment(key, event)
            except BaseException:
                pass  # the poisoned entry raises in every requester

        def segment_shard(epoch: int, slot: int, w: int):
            """Worker ``w``'s rows of segment ``slot``, or None when the
            segment cannot give every worker a row."""
            key = (epoch, slot)
            while True:
                build = False
                with shard_lock:
                    entry = shard_cache.get(key)
                    if entry is None:
                        event = threading.Event()
                        shard_cache[key] = (None, set(), event, False)
                        build = True
                    else:
                        shards, fetched, event, ready = entry
                        if ready:
                            fetched.add(w)
                            _sweep_shard_cache()
                            if isinstance(shards, BaseException):
                                raise RuntimeError(
                                    f"segment (epoch {epoch}, slot "
                                    f"{slot}) failed to build in "
                                    "another worker") from shards
                            return None if shards is None else shards[w]
                if build:
                    build_segment(key, event)
                    nxt = slot + 1
                    if (_prefetch_depth() > 0
                            and nxt < len(epoch_plan(epoch))):
                        threading.Thread(
                            target=prefetch_segment, args=(epoch, nxt),
                            daemon=True,
                            name="dkt-segment-prefetch").start()
                else:
                    event.wait()

        def note_death(w: int):
            with shard_lock:
                dead_workers.add(w)
                _sweep_shard_cache()

        def worker_loop(w: int):
            # (epoch, round) the retry callback stamps; -1 = startup.
            # Network-level failures are retried INSIDE
            # ResilientPSClient; this loop keeps the compute-level
            # budget (fault_injector, a poisoned window).
            round_ctx = [-1, -1]

            def on_retry(attempt, exc):
                retry_records.append((w, round_ctx[0], round_ctx[1]))
                telemetry.instant("worker_retry", worker=w,
                                  epoch=round_ctx[0], round=round_ctx[1])

            retry_kw = dict(retries=self.worker_retries,
                            seed=self.seed + 101 * w, on_retry=on_retry)
            socket_arm = ps_address is not None
            sharded_socket = socket_arm and self.ps_shards > 1
            shard_stats = ({"pull_shards_skipped": 0,
                            "pull_bytes_saved": 0}
                           if sharded_socket else None)
            if socket_arm:
                client = ResilientPSClient.for_address(
                    *ps_address, worker_id=w, template=center,
                    codec=codec, shards=self.ps_shards,
                    shard_stats=shard_stats, **retry_kw)
            else:
                client = ResilientPSClient.for_server(ps, w, **retry_kw)
            step = make_train_step(models[w], self.loss, tx,
                                   self.features_col, self.label_col)
            run_window = make_window_runner(step)
            overlap = self.commit_overlap
            exchange = None
            pending: list = [None]
            if overlap:
                # one-deep double buffer: window n's exchange runs here
                # while the device computes window n+1 (+1 staleness)
                exchange = ThreadPoolExecutor(
                    max_workers=1,
                    thread_name_prefix=f"dkt-ps-exchange-{w}")

            def drain_exchange():
                fut, pending[0] = pending[0], None
                return fut.result() if fut is not None else None

            wire_bytes = raw_bytes = 0
            try:
                state = TrainState.create(
                    models[w], variables, tx, device=self.device,
                    rng=rng_stream(self.seed + 1, w, device=self.device))
                residual = (tree_map(np.zeros_like, center)
                            if codec is not None else None)
                pulled = client.pull()
                for epoch in range(self.num_epoch):
                    epoch_rounds = 0  # the round's number across segments
                    for slot in range(len(epoch_plan(epoch))):
                        shard = segment_shard(epoch, slot, w)
                        stacked = (None if shard is None else
                                   _stack_batches(shard, self.batch_size,
                                                  cols))
                        if stacked is None:
                            # too few rows for this worker's batch: never
                            # trained, recorded (this worker's share)
                            rows = epoch_plan(epoch)[slot][0]
                            with accum_lock:
                                skipped_rows_per_epoch[epoch] += (
                                    len(shard) if shard is not None
                                    else rows // num_workers)
                            continue
                        n_batches = len(next(iter(stacked.values())))
                        seg_rounds = n_batches // window
                        with accum_lock:
                            dropped_per_epoch[epoch] += (
                                n_batches - seg_rounds * window)
                        for r_local in range(seg_rounds):
                            r = epoch_rounds
                            epoch_rounds += 1
                            t_round = telemetry.now()
                            batches = {
                                k: torch.from_numpy(
                                    v[r_local * window:(r_local + 1) * window]
                                ).to(self.device)
                                for k, v in stacked.items()}
                            round_ctx[0], round_ctx[1] = epoch, r
                            attempts = 0  # compute-level retry budget
                            # a retried window starts from the pre-round
                            # optimizer state, step, model state and stream
                            base = (_snapshot_state(state)
                                    if self.worker_retries else None)
                            while True:
                                try:
                                    if self.fault_injector is not None:
                                        self.fault_injector(w, epoch, r)
                                    convert.copy_from_flax(state.params,
                                                           pulled, heads)
                                    start = {n: p.detach().clone()
                                             for n, p in state.params.items()}
                                    state, metrics = run_window(state, batches)
                                    if rule.payload_kind == "params":
                                        tree = convert.params_tree(
                                            {n: p.detach() for n, p
                                             in state.params.items()}, heads)
                                    else:
                                        tree = convert.params_tree(
                                            rule.normalize_delta(
                                                {n: p.detach() - start[n]
                                                 for n, p
                                                 in state.params.items()},
                                                window), heads)
                                    # one copy to the host for the payload
                                    # and the window's losses
                                    host = serialization.to_host(
                                        {"payload": tree,
                                         "loss": metrics["loss"]})
                                    payload = host["payload"]
                                    if codec is not None:
                                        # error feedback: fold in what the
                                        # wire left out so far; retries
                                        # inside the client resend these
                                        # bytes under one seq
                                        total = tree_map(np.add, payload,
                                                         residual)
                                        if sharded_socket:
                                            encoded, applied = (
                                                codec.round_trip_shards(
                                                    total, shard_plan))
                                            enc_len = sum(len(d)
                                                          for d in encoded)
                                        else:
                                            encoded, applied = (
                                                codec.round_trip(total))
                                            enc_len = len(encoded)
                                        commit_args = (
                                            encoded if socket_arm else applied,
                                            None)
                                        residual = tree_map(np.subtract,
                                                            total, applied)
                                        wire_bytes += enc_len
                                        raw_bytes += raw_nbytes(payload)
                                    else:
                                        commit_args = (
                                            payload,
                                            payload if rule.pull_uses_local
                                            else None)
                                    if overlap:
                                        got = drain_exchange()
                                        if got is not None:
                                            pulled = got
                                        pending[0] = exchange.submit(
                                            client.commit, *commit_args)
                                    else:
                                        pulled = client.commit(*commit_args)
                                    break
                                except PSRetryExhausted:
                                    # the network budget died inside the
                                    # client; a recompute cannot revive it
                                    raise
                                except Exception:
                                    attempts += 1
                                    if attempts > self.worker_retries:
                                        raise
                                    retry_records.append((w, epoch, r))
                                    telemetry.instant("worker_retry", worker=w,
                                                      epoch=epoch, round=r)
                                    _restore_state(state, base)
                                    if overlap:
                                        drain_exchange()
                                    pulled = client.pull()
                            round_records.append(
                                (w, epoch, float(np.mean(host["loss"]))))
                            telemetry.complete("worker_round", t_round,
                                               worker=w, epoch=epoch, round=r)
                    if epoch_rounds == 0:
                        raise ValueError(
                            f"worker {w}: not enough batches per "
                            f"worker for one communication window "
                            f"({window}) in any segment")
                if overlap:
                    # the last window's exchange must land before the
                    # clean finish
                    drain_exchange()
                client.done()
                client.close()
            except BaseException as e:  # handled by the join below
                note_death(w)
                failures.append((w, e))
                flight_recorder.record("worker_death", worker=w,
                                       error=repr(e))
            finally:
                if exchange is not None:
                    exchange.shutdown(wait=False)
                if codec is not None:
                    wire_total.inc(wire_bytes)
                    raw_total.inc(raw_bytes)
                    m = telemetry.metrics()
                    m.counter("commit_wire_bytes_total").inc(wire_bytes)
                    m.counter("commit_raw_bytes_total").inc(raw_bytes)
                if shard_stats is not None:
                    skip_total.inc(shard_stats["pull_shards_skipped"])
                    saved_total.inc(shard_stats["pull_bytes_saved"])

        threads = [threading.Thread(target=worker_loop, args=(w,),
                                    name=f"dkt-worker-{w}")
                   for w in range(num_workers)]
        for t in threads:
            t.start()
        # active failure detection: a watchdog samples the PS contact
        # heartbeat and records workers silent beyond worker_timeout
        detected: list[list[int]] = []
        watcher = None
        stop_watch = threading.Event()
        if self.worker_timeout is not None and ps is not None:
            for w in range(num_workers):
                ps.register(w)

            def watchdog():
                while not stop_watch.wait(self.worker_timeout / 4):
                    idle = sorted(i for i in ps.idle_workers(
                        self.worker_timeout) if i < num_workers)
                    if idle and (not detected or detected[-1] != idle):
                        detected.append(idle)
                        telemetry.instant("idle_workers", workers=idle)

            watcher = threading.Thread(target=watchdog, daemon=True)
            watcher.start()
        try:
            for t in threads:
                t.join()
        finally:
            stop_watch.set()
            if watcher is not None:
                watcher.join()
        if detected:
            self._record(detected_idle_workers=detected)
        if server is not None:
            server.stop()
        failures = failures.values()
        retry_records = retry_records.values()
        round_records = round_records.values()
        if failures and (len(failures) > self.max_worker_failures
                         or len(failures) == num_workers):
            raise failures[0][1]
        if failures:
            # the dead workers' committed rounds stay in the center;
            # the survivors carried the rest
            self._record(worker_failures=[(w, repr(e))
                                          for w, e in failures])
        if retry_records:
            self._record(worker_round_retries=retry_records)
        if ps is not None and ps.num_snapshots:
            self._record(ps_snapshots=ps.num_snapshots)
        if codec is not None:
            self._record(commit_wire_bytes=int(wire_total.value),
                         commit_raw_bytes=int(raw_total.value))
        if self.ps_shards > 1 and self.transport == "socket":
            self._record(pull_shards_skipped=int(skip_total.value),
                         pull_bytes_saved=int(saved_total.value))
        self._record(slo_health=telemetry.metrics().health()["state"])
        for _, _, loss in round_records:
            self._record(round_loss=loss)
        sums = np.zeros((self.num_epoch, 2))
        for _, e, loss in round_records:
            sums[e] += (loss, 1.0)
        for epoch in range(self.num_epoch):
            self._record(epoch_loss=float(sums[epoch, 0]
                                          / max(sums[epoch, 1], 1.0)),
                         dropped_tail_batches=int(dropped_per_epoch[epoch]))
            if skipped_rows_per_epoch[epoch]:
                self._record(
                    skipped_segment_rows=int(skipped_rows_per_epoch[epoch]))
        if ps is not None:
            self._record(staleness=list(ps.staleness_log))
            final_center = ps.center
        else:
            # external ps_address: the final center comes over the
            # wire; the staleness log stays with the server
            fin = PSClient(*self.ps_address, worker_id=num_workers,
                           template=center)
            try:
                final_center = fin.pull()
                fin.done()
            finally:
                fin.close()
        self.parameter_server_state = ps
        trained = {n: v.to(self.device)
                   for n, v in convert.params_from_flax(final_center).items()}
        self.trained_variables = {**trained, **model_state}
        self.model.load_state_dict(self.trained_variables)
        # free-running threads have no common epoch boundary: the final
        # center is evaluated once
        self._eval_epoch(self.trained_variables)
        return self.trained_variables


class DOWNPOUR(DistributedTrainer):
    """Dean et al. async SGD (reference ``DOWNPOUR``)."""

    def allocate_rule(self):
        return DownpourRule()

    def _lr_law(self):
        f = self.num_workers * self.communication_window
        return (f, f, "learning_rate / (num_workers * "
                "communication_window)")


class ADAG(DistributedTrainer):
    """Asynchronous Distributed Adaptive Gradients — window-normalized
    deltas (the reference's flagship, ``ADAG``)."""

    def allocate_rule(self):
        return AdagRule()

    def _lr_law(self):
        return (self.num_workers, self.num_workers,
                "learning_rate / num_workers")


class DynSGD(DistributedTrainer):
    """Staleness-scaled commits (reference ``DynSGD``)."""

    def allocate_rule(self):
        return DynSGDRule()

    def _lr_law(self):
        return (self.communication_window, self.communication_window,
                "learning_rate / communication_window")


class AEASGD(DistributedTrainer):
    """Asynchronous Elastic Averaging SGD (Zhang et al.; reference
    ``AEASGD``).  ``alpha = learning_rate * rho`` as in the paper's
    stability condition."""

    def __init__(self, model, rho: float = 5.0, **kwargs):
        kwargs.setdefault("learning_rate", 0.01)
        super().__init__(model, **kwargs)
        self.rho = float(rho)

    @property
    def alpha(self) -> float:
        try:
            lr = float(self.learning_rate)
        except (TypeError, ValueError):
            raise ValueError(
                "the elastic family derives alpha = learning_rate * "
                "rho (the paper's stability condition), which needs a "
                "scalar learning_rate — schedules are not supported "
                f"here, got {self.learning_rate!r}") from None
        return lr * self.rho

    def allocate_rule(self):
        return ElasticRule(alpha=self.alpha)


class EAMSGD(AEASGD):
    """AEASGD with Nesterov momentum in the worker loop (reference
    ``EAMSGD`` — same server law, momentum on the worker)."""

    def __init__(self, model, momentum: float = 0.9, **kwargs):
        kwargs.setdefault("worker_optimizer", "nesterov")
        # before super(): _apply_lr_law runs in the base __init__ and
        # reads the momentum
        self.momentum = momentum
        super().__init__(model, **kwargs)

    def _lr_law(self):
        if self.worker_optimizer != "nesterov" or self.momentum >= 1:
            return super()._lr_law()
        # Nesterov workers amplify the step ~1/(1-m) transiently (the
        # warning threshold); the measured correction is lr/2
        return (1.0 / (1.0 - self.momentum), 2.0,
                "learning_rate / 2 (the measured momentum-law row "
                "at the default momentum=0.9)")

    def _tx(self):
        if self.worker_optimizer == "nesterov":
            return resolve_optimizer("nesterov", self.learning_rate,
                                     m=self.momentum)
        return super()._tx()


class _MemberParallelTrainer(Trainer):
    """Shared engine of Ensemble/Averaging (reference
    ``_MemberParallelTrainer``): ``num_models`` members, each its own
    ``TrainState`` and stream (``rng_stream(seed + 1, i)``), train on
    disjoint shards of one ``dataset.shuffle(seed).repartition(n)``;
    each epoch member i's shard is shuffled with ``seed + 13 * epoch +
    i`` and every member runs the fewest batches any member has.  The
    reference ``vmap``s the members into one program; the port runs
    them in turn on its one device, chunk by chunk (``SCAN_CHUNK``
    steps each), which gives each member the same steps.  History:
    ``epoch_loss`` (the members' mean), ``member_loss`` (each member's
    epoch mean).  ``member_variables``: each member's trained
    variables.  Checkpointing raises ``ValueError``, as the
    reference's."""

    SCAN_CHUNK = 32

    #: False -> every member shares one init (the averaging setting);
    #: True -> member i's init drawn from ``seed + i``
    distinct_inits: ClassVar[bool] = True

    def __init__(self, model, num_models: int = 2, **kwargs):
        super().__init__(model, **kwargs)
        self.num_models = int(num_models)
        self.member_variables: list[dict] = []

    def train(self, dataset: Dataset, initial_variables=None,
              resume_from: str | None = None,
              eval_dataset: Dataset | None = None):
        self._guard_no_checkpoint(resume_from)
        return super().train(dataset, initial_variables,
                             eval_dataset=eval_dataset)

    def _guard_no_checkpoint(self, resume_from):
        if resume_from is not None or self.checkpoint_dir is not None:
            raise ValueError(
                f"{type(self).__name__} does not support checkpointing;"
                " checkpoint the member SingleTrainers instead")

    def _member_states(self, initial_variables) -> list[TrainState]:
        """One state per member: ``initial_variables`` for all where
        given, else member i's init drawn from ``seed + i``
        (``distinct_inits``) or the model's own, from ``seed``."""
        tx = self._tx()
        n = self.num_models
        if initial_variables is not None:
            inits = [dict(initial_variables)] * n
        elif self.distinct_inits:
            inits = [self._build_seeded(self.seed + i).state_dict()
                     for i in range(n)]
        else:
            inits = [self.model.state_dict()] * n
        return [TrainState.create(self.model, v, tx, device=self.device,
                                  rng=rng_stream(self.seed + 1, i,
                                                 device=self.device))
                for i, v in enumerate(inits)]

    def _train_members(self, dataset, initial_variables
                       ) -> list[TrainState]:
        n = self.num_models
        states = self._member_states(initial_variables)
        step = make_train_step(self.model, self.loss, self._tx(),
                               self.features_col, self.label_col)
        run_chunk = make_window_runner(step)
        cols = self._columns()
        # partitioned once, after one shuffle: member i sees only its own
        # 1/n of the rows for the whole run (an in-memory ``Dataset``, as
        # in the JAX package: a ``ShardedDataset`` has no ``shuffle``)
        member_shards = dataset.shuffle(seed=self.seed).repartition(n)
        for epoch in range(self.num_epoch):
            per_member = [
                _stack_batches(s.shuffle(seed=self.seed + 13 * epoch + i),
                               self.batch_size, cols)
                for i, s in enumerate(member_shards)]
            if any(p is None for p in per_member):
                raise ValueError("a member shard is smaller than one batch")
            n_batches = min(len(next(iter(p.values())))
                            for p in per_member)
            losses = []
            for lo in range(0, n_batches, self.SCAN_CHUNK):
                hi = min(lo + self.SCAN_CHUNK, n_batches)
                member_losses = []
                for state, p in zip(states, per_member):
                    chunk = {k: torch.from_numpy(p[k][lo:hi]).to(
                                 self.device) for k in cols}
                    _, metrics = run_chunk(state, chunk)
                    member_losses.append(metrics["loss"])
                # [M, chunk]: one device-to-host copy per chunk
                losses.append(torch.stack(member_losses).cpu().numpy())
            per_member_loss = np.concatenate(losses, axis=1).mean(axis=1)
            self._record(epoch_loss=float(per_member_loss.mean()),
                         member_loss=[float(x) for x in per_member_loss])
        self.member_variables = [s.variables() for s in states]
        return states


class EnsembleTrainer(_MemberParallelTrainer):
    """Train ``num_models`` independent members (inits from ``seed +
    i``, disjoint data shards); returns the list of their variables
    (reference ``EnsembleTrainer``), also kept as
    ``ensemble_variables``; ``trained_variables`` is member 0's, which
    is loaded into ``self.model``."""

    distinct_inits: ClassVar[bool] = True

    def _train(self, dataset, initial_variables, resume_from=None):
        self._train_members(dataset, initial_variables)
        results = self.member_variables
        self.trained_variables = results[0]
        self.ensemble_variables = results
        self.model.load_state_dict(results[0])
        return results


class AveragingTrainer(_MemberParallelTrainer):
    """Train ``num_workers`` members on disjoint shards from one shared
    init, then average their parameters: one-shot model averaging
    (reference ``AveragingTrainer``).  Returns the mean of the members'
    parameters with member 0's model state, also kept as
    ``trained_variables`` and loaded into ``self.model``."""

    distinct_inits: ClassVar[bool] = False

    def __init__(self, model, num_workers: int = 2, **kwargs):
        super().__init__(model, num_models=num_workers, **kwargs)

    @property
    def num_workers(self) -> int:
        return self.num_models

    def _train(self, dataset, initial_variables, resume_from=None):
        states = self._train_members(dataset, initial_variables)
        with torch.no_grad():
            mean = {k: torch.stack([s.params[k] for s in states]).mean(0)
                    for k in states[0].params}
        self.trained_variables = {**mean, **states[0].model_state}
        self.model.load_state_dict(self.trained_variables)
        return self.trained_variables
