"""Parameter-server update rules over parameter dicts, the port of
``distkeras_tpu/parallel/update_rules.py``.

DOWNPOUR, ADAG, AEASGD, EAMSGD and DynSGD are each a *(commit payload,
server update, worker pull)* triple, parameterized by a communication
window and (for DynSGD) commit staleness.  As in the JAX package they
are pure functions: a commit returns a new ``PSState`` of new tensors
and leaves its inputs alone, so the center before a commit stays
available to the pull law.

Staleness model: within an emulated round every worker pulls the center,
runs ``communication_window`` local steps, and the parameter server
applies the resulting commits in a per-round permuted order; the i-th
commit in that order has staleness i (plus an offset in the pipelined
round).  The JAX package's ``lax.scan`` over the commit order is a
Python loop here, in the same order.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar, NamedTuple, Sequence

import numpy as np

from distkeras_tpu_torch.utils import tree_add, tree_axpy, tree_lerp


class PSState(NamedTuple):
    """Server-side state: the center parameters plus a commit clock (the
    reference DynSGD server's global update counter)."""

    center: dict
    clock: int  # total commits applied


@dataclasses.dataclass(frozen=True)
class UpdateRule:
    """Base class. Subclasses define the server commit + worker pull laws."""

    #: 'delta' — worker commits (local - last_pulled); 'params' — worker
    #: commits its full local parameters (elastic family).
    payload_kind: ClassVar[str] = "delta"

    #: Whether ``worker_pull`` reads its ``local`` argument.
    pull_uses_local: ClassVar[bool] = False

    def init_state(self, center: dict) -> PSState:
        return PSState(center=center, clock=0)

    def commit(self, state: PSState, payload: dict,
               staleness: int) -> PSState:
        raise NotImplementedError

    def worker_pull(self, local, center_pre: dict,
                    center_post: dict) -> dict:
        """New local params after this worker's own commit: by default
        (the DOWNPOUR family) the center as of just after it."""
        del local, center_pre
        return center_post

    def normalize_delta(self, delta: dict, window: int) -> dict:
        """Worker-side transform of the accumulated delta before commit."""
        del window
        return delta


@dataclasses.dataclass(frozen=True)
class DownpourRule(UpdateRule):
    """DOWNPOUR (Dean et al., 2012): ``center += delta``."""

    def commit(self, state, payload, staleness):
        del staleness
        return PSState(center=tree_add(state.center, payload),
                       clock=state.clock + 1)


@dataclasses.dataclass(frozen=True)
class AdagRule(UpdateRule):
    """ADAG: the worker divides its accumulated delta by the window
    before committing; the server applies it additively.  The JAX
    package's reconstruction of the normalization (its provenance note,
    ``update_rules.py`` ``AdagRule``) is kept as it is: a division by
    ``float(window)``."""

    def commit(self, state, payload, staleness):
        del staleness
        return PSState(center=tree_add(state.center, payload),
                       clock=state.clock + 1)

    def normalize_delta(self, delta, window):
        return {k: d / float(window) for k, d in delta.items()}


def dynsgd_scale(staleness) -> float:
    """``1 / (staleness + 1)`` taken in f32, as the JAX rule takes it."""
    return float(np.float32(1.0) / (np.float32(staleness) + np.float32(1.0)))


@dataclasses.dataclass(frozen=True)
class DynSGDRule(UpdateRule):
    """DynSGD: ``center += delta / (staleness + 1)``."""

    def commit(self, state, payload, staleness):
        return PSState(center=tree_axpy(dynsgd_scale(staleness), payload,
                                        state.center),
                       clock=state.clock + 1)


@dataclasses.dataclass(frozen=True)
class ElasticRule(UpdateRule):
    """AEASGD / EAMSGD server law (Zhang, Choromanska & LeCun, 2015):
    ``center <- (1-alpha) center + alpha x_i`` and the symmetric worker
    move ``x_i <- x_i - alpha (x_i - center)`` against the center the
    server used for this commit."""

    alpha: float = 0.5
    payload_kind: ClassVar[str] = "params"
    pull_uses_local: ClassVar[bool] = True

    def commit(self, state, payload, staleness):
        del staleness
        return PSState(center=tree_lerp(state.center, payload, self.alpha),
                       clock=state.clock + 1)

    def worker_pull(self, local, center_pre, center_post):
        del center_post
        return tree_lerp(local, center_pre, self.alpha)


def apply_commit_round(rule: UpdateRule, state: PSState,
                       payloads: Sequence[dict]
                       ) -> tuple[PSState, list, list]:
    """Apply one round of commits in order (``payloads`` in commit
    order).  Returns ``(new_state, centers_pre, centers_post)``: for each
    commit, the center just before and just after it."""
    base_clock = state.clock
    pre, post = [], []
    for payload in payloads:
        new = rule.commit(state, payload, state.clock - base_clock)
        pre.append(state.center)
        post.append(new.center)
        state = new
    return state, pre, post


def apply_commit_round_pulls(rule: UpdateRule, state: PSState,
                             payloads: Sequence[dict],
                             locals_: Sequence[dict] | None,
                             staleness_offset: int = 0
                             ) -> tuple[PSState, list]:
    """The commit round with each committing worker's pull computed as
    its commit lands: returns ``(new_state, pulled)``, ``pulled`` in
    commit order.  ``locals_`` are the workers' post-window parameters
    in commit order, or ``None`` for rules whose pull ignores them.
    ``staleness_offset`` adds a constant to every commit's staleness
    (the pipelined round runs one round behind)."""
    base_clock = state.clock
    pulled = []
    for i, payload in enumerate(payloads):
        staleness = state.clock - base_clock + staleness_offset
        new = rule.commit(state, payload, staleness)
        pulled.append(rule.worker_pull(
            None if locals_ is None else locals_[i], state.center,
            new.center))
        state = new
    return state, pulled


RULES = {
    "downpour": DownpourRule,
    "adag": AdagRule,
    "dynsgd": DynSGDRule,
    "aeasgd": ElasticRule,
    "eamsgd": ElasticRule,
}
