"""Lowering tiers: the ``fidelity=`` registry, the port's copy of
``distkeras_tpu/parallel/tiers.py`` (the same table, so both packages
validate ``fidelity`` alike and name the same capabilities).

The tiers are lowerings of the same PS-round semantics: ``host`` (free-
running worker threads against a host parameter server), ``faithful``
and ``fast`` (the emulated rounds of ``ps_emulator``: commits
serialized by a seeded permutation, scanned or in closed form) and
``mesh`` (a data plane with the center sharded over the workers).  The
port runs ``host``, ``faithful`` and ``fast``; the trainers raise
``NotImplementedError`` for ``mesh`` (ROADMAP.md §1 item 8).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class LoweringTier:
    """Capabilities of one ``fidelity=`` lowering tier."""

    name: str
    #: "host-wire" (threads + transport), "emulated" (one round program,
    #: stacked workers), or "mesh" (sharded center)
    data_plane: str
    #: real concurrency (racing threads): gates the host-only kwargs
    concurrent: bool
    #: bit-replayable under a fixed seed
    deterministic: bool
    #: supports commit_overlap=True (a commit phase that can pipeline
    #: against the next window)
    commit_overlap: bool
    #: supports model_parallel > 1 (tensor-parallel worker programs)
    model_parallel: bool
    #: supports checkpoint/resume of mid-training state
    checkpoint: bool
    #: lowers comm compression inside the round (``comm_dtype``/
    #: ``comm_codec``/``metrics_every``)
    comm_compression: bool
    #: supports sampled round attribution (``attrib_every``)
    round_attrib: bool


TIERS = {
    "host": LoweringTier(
        name="host", data_plane="host-wire", concurrent=True,
        deterministic=False, commit_overlap=True, model_parallel=False,
        checkpoint=False, comm_compression=False, round_attrib=False),
    "faithful": LoweringTier(
        name="faithful", data_plane="emulated", concurrent=False,
        deterministic=True, commit_overlap=True, model_parallel=True,
        checkpoint=True, comm_compression=False, round_attrib=False),
    "fast": LoweringTier(
        name="fast", data_plane="emulated", concurrent=False,
        deterministic=True, commit_overlap=False, model_parallel=True,
        checkpoint=True, comm_compression=False, round_attrib=False),
    "mesh": LoweringTier(
        name="mesh", data_plane="mesh", concurrent=False,
        deterministic=True, commit_overlap=True, model_parallel=False,
        checkpoint=False, comm_compression=True, round_attrib=True),
}


def valid_tiers() -> list[str]:
    return sorted(TIERS)


def tiers_with(capability: str) -> list[str]:
    """Tier names whose ``capability`` flag is set."""
    return sorted(n for n, t in TIERS.items()
                  if getattr(t, capability))


def resolve_tier(name: str) -> LoweringTier:
    if name not in TIERS:
        raise ValueError(
            f"unknown fidelity {name!r}; valid lowering tiers: "
            f"{valid_tiers()}")
    return TIERS[name]
