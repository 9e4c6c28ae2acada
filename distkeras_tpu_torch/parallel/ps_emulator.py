"""Emulation of the asynchronous parameter server, the port of
``distkeras_tpu/parallel/ps_emulator.py``.

Each emulated round every worker runs a communication window of local
steps, and the server applies the resulting commits in a per-round
permuted order; the i-th commit in that order has staleness i — the
quantity the reference's DynSGD server reads off its update counter,
but deterministic and replayable.

Two fidelities, as in the JAX package:

* ``faithful`` — commits applied one after another
  (``update_rules.apply_commit_round_pulls``); each worker's pull sees
  exactly the center its commit position implies.
* ``fast`` — the closed form for the linear rules: the round's center
  update is one weighted sum over the workers' payloads, and every
  worker pulls the round-final center (the elastic family moves against
  the round-start center).

Where the JAX round ``vmap``s the workers over one stacked state, the
port holds one ``TrainState`` per worker and runs their windows in turn
on the same device; the workers do not interact before the commits, so
the round's result is the same.  (A ``torch.func.vmap`` would hand the
GroupNorm kernels one gamma per worker; they take one.)  Parameters are
updated in place by the optimizer, so a worker adopting a center takes
its own copy.
"""

from __future__ import annotations

from typing import Callable, Iterator, Mapping, Sequence

import numpy as np
import torch

from distkeras_tpu_torch.parallel.update_rules import (
    DynSGDRule,
    ElasticRule,
    PSState,
    UpdateRule,
    apply_commit_round_pulls,
    dynsgd_scale,
)
from distkeras_tpu_torch.utils import tree_sub
from distkeras_tpu_torch.workers import TrainState, make_window_runner


def _order(perm) -> list[int]:
    return [int(p) for p in (perm.tolist() if hasattr(perm, "tolist")
                             else perm)]


def _inverse(perm: list[int]) -> list[int]:
    """``inv[w]`` = commit position of worker ``w``."""
    inv = [0] * len(perm)
    for i, w in enumerate(perm):
        inv[w] = i
    return inv


def _params(state: TrainState) -> dict:
    return {k: p.detach() for k, p in state.params.items()}


def _windows(window_run, worker_states, batches):
    """Each worker's window in turn; returns the stacked ``[W, window]``
    metrics."""
    per_worker = []
    for w, state in enumerate(worker_states):
        _, m = window_run(state, {k: v[w] for k, v in batches.items()})
        per_worker.append(m)
    return {k: torch.stack([m[k] for m in per_worker])
            for k in per_worker[0]}


def _metrics(step_metrics, inv, offset=0):
    return {"loss": step_metrics["loss"].mean(dim=1),            # [W]
            "grad_norm": step_metrics["grad_norm"].mean(dim=1),
            "staleness": torch.tensor([i + offset for i in inv],
                                      dtype=torch.int32)}


def make_round_fn(rule: UpdateRule, step_fn: Callable,
                  fidelity: str = "faithful") -> Callable:
    """Build ``round_fn(ps_state, worker_states, batches, perm)``:

    * ``ps_state`` — ``PSState`` (center params + commit clock),
    * ``worker_states`` — one ``TrainState`` per worker (updated in
      place and returned),
    * ``batches`` — column dict, tensors ``[W, window, B, ...]``,
    * ``perm`` — this round's commit order (``perm[i]`` = worker
      committing i-th).

    Returns ``(ps_state, worker_states, metrics)``; ``metrics`` holds the
    per-worker mean loss and grad norm and the per-worker staleness."""
    if fidelity not in ("faithful", "fast"):
        raise ValueError(f"unknown fidelity {fidelity!r}")
    window_run = make_window_runner(step_fn)

    def round_fn(ps_state: PSState, worker_states: Sequence[TrainState],
                 batches: Mapping[str, torch.Tensor], perm):
        perm = _order(perm)
        num_workers = len(perm)
        window = next(iter(batches.values())).shape[1]
        center = ps_state.center
        if rule.payload_kind == "delta":
            # round-start pull: every worker adopts the current center
            for state in worker_states:
                state.adopt(center)
        step_metrics = _windows(window_run, worker_states, batches)
        inv = _inverse(perm)
        # a profiler range (free when no profiler runs): the commits'
        # share of a round's device time
        with torch.no_grad(), torch.profiler.record_function("ps_commits"):
            local = [_params(s) for s in worker_states]
            if rule.payload_kind == "delta":
                payloads = [rule.normalize_delta(tree_sub(p, center), window)
                            for p in local]
            else:
                payloads = local
            if fidelity == "faithful":
                ps_state, ordered_pulled = apply_commit_round_pulls(
                    rule, ps_state, [payloads[w] for w in perm],
                    [local[w] for w in perm] if rule.pull_uses_local
                    else None)
                pulled = [ordered_pulled[inv[w]]
                          for w in range(num_workers)]
            else:
                ps_state, pulled = _fast_round(rule, ps_state, payloads,
                                               local, inv)
            for state, p in zip(worker_states, pulled):
                state.adopt(p)
        return ps_state, worker_states, _metrics(step_metrics, inv)

    return round_fn


def make_pipelined_round_fn(rule: UpdateRule,
                            step_fn: Callable) -> Callable:
    """Commit-pipelined round: round ``k``'s window and round ``k-1``'s
    commits.  Every commit lands one round later than in the in-order
    emulator, i.e. with a uniform +W staleness (W workers per round),
    passed to the rule as ``staleness_offset``; pulls are round-barrier
    pulls.  Delta-payload rules only: the elastic family's commit reads
    the committing worker's current parameters.

    ``round_fn(ps_state, worker_states, batches, perm, pending,
    pending_perm, pending_valid)`` returns ``(ps_state, worker_states,
    metrics, payloads, perm, valid)``: thread the last three back in as
    the next round's pending commit, and fold the final pending round
    in with ``flush_pending``.  ``pending`` is one payload per worker (in
    worker order) or ``None``."""
    if rule.payload_kind != "delta":
        raise ValueError(
            "commit pipelining supports the delta-payload family "
            "(DOWNPOUR/ADAG/DynSGD); the elastic family's commits "
            "read the committing worker's current locals — a "
            "read-modify-write against the running window, which "
            "cannot overlap")
    window_run = make_window_runner(step_fn)

    def round_fn(ps_state: PSState, worker_states: Sequence[TrainState],
                 batches: Mapping[str, torch.Tensor], perm, pending,
                 pending_perm, pending_valid: bool):
        perm = _order(perm)
        num_workers = len(perm)
        window = next(iter(batches.values())).shape[1]
        # the pulls adopted at the last round's end
        start = [{k: p.clone() for k, p in _params(s).items()}
                 for s in worker_states]
        step_metrics = _windows(window_run, worker_states, batches)
        with torch.no_grad(), torch.profiler.record_function("ps_commits"):
            payloads = [rule.normalize_delta(tree_sub(_params(s), st),
                                             window)
                        for s, st in zip(worker_states, start)]
            if pending_valid:
                ps_state, _ = apply_commit_round_pulls(
                    rule, ps_state,
                    [pending[w] for w in _order(pending_perm)], None,
                    staleness_offset=num_workers)
            for state in worker_states:
                state.adopt(ps_state.center)
        metrics = _metrics(step_metrics, _inverse(perm), num_workers)
        return ps_state, worker_states, metrics, payloads, perm, True

    return round_fn


def flush_pending(rule: UpdateRule, ps_state: PSState, pending,
                  pending_perm, num_workers: int) -> PSState:
    """Apply the final round's still-pending commits at their true
    depth: position in the commit order only (``staleness_offset=0``),
    since no younger window runs ahead of them at the drain.
    ``num_workers`` is kept in the signature as the JAX package keeps
    it."""
    del num_workers
    with torch.no_grad():
        ps_state, _ = apply_commit_round_pulls(
            rule, ps_state, [pending[w] for w in _order(pending_perm)],
            None, staleness_offset=0)
    return ps_state


def _stacked(trees: Sequence[dict], key: str) -> torch.Tensor:
    return torch.stack([t[key] for t in trees])


def _fast_round(rule: UpdateRule, ps_state: PSState, payloads, local_params,
                inv: list[int]):
    """Closed-form center update + deferred pulls (see the module
    docstring); the weights are taken in f32 as the JAX round takes
    them."""
    center = ps_state.center
    num_workers = len(inv)
    pos = np.asarray(inv, dtype=np.float32)
    dev = next(iter(center.values())).device
    if isinstance(rule, ElasticRule):
        # center_W = (1-a)^W c0 + a * sum_w (1-a)^(W-1-pos_w) * x_w
        a = rule.alpha
        decay = (1.0 - a) ** num_workers
        coeff = torch.from_numpy(
            np.float32(a) * np.float32(1.0 - a)
            ** (np.float32(num_workers - 1.0) - pos)).to(dev)
        new_center = {k: decay * c + torch.tensordot(
                          coeff, _stacked(payloads, k), dims=1)
                      for k, c in center.items()}
        # worker move against the round-start center
        pulled = [rule.worker_pull(p, center, center) for p in local_params]
    else:
        if isinstance(rule, DynSGDRule):
            scale = [dynsgd_scale(i) for i in inv]
        else:
            scale = [1.0] * num_workers
        scale = torch.tensor(scale, dtype=torch.float32, device=dev)
        new_center = {k: c + torch.tensordot(scale, _stacked(payloads, k),
                                              dims=1)
                      for k, c in center.items()}
        pulled = [new_center] * num_workers
    return PSState(center=new_center,
                   clock=ps_state.clock + num_workers), pulled


def commit_permutation(generator: torch.Generator,
                       num_workers: int) -> list[int]:
    """Per-round commit order — the emulator's stand-in for the TCP
    race — drawn from ``generator``."""
    return torch.randperm(num_workers, generator=generator).tolist()


def commit_permutations(seed: int, num_workers: int) -> Iterator[list[int]]:
    """The rounds' commit orders, one per round, from a generator seeded
    with ``seed``.  The draws differ from ``jax.random``'s; a test that
    holds the port against the JAX package substitutes JAX's sequence."""
    gen = torch.Generator().manual_seed(seed)
    while True:
        yield commit_permutation(gen, num_workers)
