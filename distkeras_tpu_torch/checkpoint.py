"""Checkpoint files and PS snapshots, the port of
``distkeras_tpu/checkpoint.py``, in the same format: either package
reads the other's files.

A checkpoint is one msgpack file in flax's encoding
(``serialization.py``): ``{"state": <state dict>, "cursor": <JSON>}``,
where the state dict is the JAX package's layout of the trainer's state
(``convert.train_state_to_flax``: one ``TrainState``, or for the PS
trainers ``{"perm_key", "ps": {"center", "clock"}, "workers"}`` with a
leading worker axis) and the cursor says where training stands (epoch,
round, the history).  The port adds one top-level entry,
``"torch_streams"``: the exact states of its random streams (each
``torch.Generator``'s ``get_state()``) and how many commit orders the
run has drawn.  The JAX package's loader restores only the keys of its
template and ignores this one; the port reads it where present, and
seeds its streams from the key leaves where not (a JAX-written file).
No random stream crosses between the packages.

Writes are atomic (tmp + rename).  A path is a directory (the file
``ckpt_latest.msgpack`` in it, created as needed) or an explicit
``.msgpack``/``.ckpt`` file; any other path, dotted directory names
included, is a directory.

PS snapshots are template-free free-form trees (``save_ps_snapshot``/
``load_ps_snapshot``), byte for byte the JAX package's.  The sharded
(orbax) layout waits for the multi-host work (ROADMAP.md §1 item 8):
``has_sharded`` finds one, and the trainers refuse to resume from it.
"""

from __future__ import annotations

import json
import os
import pathlib
from typing import Any, Mapping

from distkeras_tpu_torch import serialization

LATEST = "ckpt_latest.msgpack"
STREAMS = "torch_streams"
SHARDED = "ckpt_sharded"
_POINTER = "LATEST"


def _write(path: pathlib.Path, pieces: list) -> None:
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:
        f.writelines(pieces)
    os.replace(tmp, path)


def checkpoint_file(path: str | os.PathLike, create: bool = False
                    ) -> pathlib.Path:
    """The file a checkpoint ``path`` names (see the module docstring);
    ``create`` makes the directories a write needs."""
    path = pathlib.Path(path)
    if path.suffix in (".msgpack", ".ckpt") and not path.is_dir():
        if create:
            path.parent.mkdir(parents=True, exist_ok=True)
        return path
    if create:
        path.mkdir(parents=True, exist_ok=True)
    return path / LATEST


def save_checkpoint(path: str | os.PathLike, state, cursor: Mapping,
                    streams: Mapping | None = None) -> str:
    """Atomically write ``{"state": state, "cursor": json(cursor)}``
    (plus the port's ``streams`` entry when given); returns the file
    path.  Tensor leaves may live on a card: they come to the host with
    one synchronisation (``serialization.to_host``)."""
    path = checkpoint_file(path, create=True)
    payload = {"state": serialization.device_get(state),
               "cursor": json.dumps(dict(cursor))}
    if streams is not None:
        payload[STREAMS] = streams
    _write(path, serialization.pack_pieces(
        serialization.to_state_dict(payload)))
    return str(path)


def load_checkpoint(path: str | os.PathLike, state_template=None,
                    streams: bool = False):
    """Read a checkpoint of either package.  Returns ``(state, cursor)``
    (``state`` the state dict, numpy leaves; restricted to the
    template's structure when ``state_template`` is given, which raises
    on a key the file lacks), or ``(state, cursor, streams)`` with the
    port's stream entry (``None`` in a JAX-written file)."""
    payload = serialization.msgpack_restore(
        checkpoint_file(path).read_bytes())
    state = payload["state"]
    if state_template is not None:
        state = serialization.from_state_dict(state_template, state)
    cursor = json.loads(payload["cursor"])
    if streams:
        return state, cursor, payload.get(STREAMS)
    return state, cursor


def save_ps_snapshot(path: str | os.PathLike, snapshot: Mapping) -> str:
    """Atomic free-form write of a parameter-server snapshot, restored
    without a template (a restarting server has none): flax's
    self-describing ``msgpack_serialize`` encoding of the snapshot's
    host copy (numpy scalars as 0-d arrays, as ``jax.device_get``
    leaves them), dicts in key order."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    _write(path, serialization.pack_pieces(serialization.sort_keys(
        serialization.device_get(snapshot))))
    return str(path)


def load_ps_snapshot(path: str | os.PathLike) -> Any:
    """Inverse of ``save_ps_snapshot``; no template needed."""
    return serialization.msgpack_restore(pathlib.Path(path).read_bytes())


def ps_snapshot_info(path: str | os.PathLike) -> dict:
    """Which server wrote a snapshot and how far it got: ``{"sharded": K
    or None, "num_commits", "workers_cached", "last_acked", "epoch"}``
    (the JAX package's ``ps_snapshot_info``; on a sharded snapshot
    ``last_acked`` is each worker's lowest sequence over the shards)."""
    snap = load_ps_snapshot(path)
    epoch = int(snap.get("epoch", 0))
    if "sharded" in snap:
        shards = snap["shards"]
        acked: dict[str, int] = {}
        for s in shards:
            for w, e in s["last_reply"].items():
                seq = int(e["seq"])
                acked[w] = min(acked.get(w, seq), seq)
        return {"sharded": int(snap["sharded"]),
                "num_commits": int(shards[0]["num_commits"]),
                "workers_cached": len({w for s in shards
                                       for w in s["last_reply"]}),
                "last_acked": acked, "epoch": epoch}
    return {"sharded": None,
            "num_commits": int(snap["num_commits"]),
            "workers_cached": len(snap["last_reply"]),
            "last_acked": {w: int(e["seq"])
                           for w, e in snap["last_reply"].items()},
            "epoch": epoch}


def ps_snapshot_center(snapshot) -> Any:
    """The center parameter tree of a PS snapshot (a dict or a file)."""
    if isinstance(snapshot, (str, os.PathLike)):
        snapshot = load_ps_snapshot(snapshot)
    if "center" not in snapshot:
        raise ValueError(
            "not a PS snapshot: no 'center' key (expected a file "
            "written by save_ps_snapshot / HostParameterServer."
            "save_snapshot / ShardedParameterServer.save_snapshot)")
    return snapshot["center"]


def has_sharded(path: str | os.PathLike) -> bool:
    """True if ``path`` holds a complete sharded (orbax) checkpoint."""
    root = pathlib.Path(path) / SHARDED
    pointer = root / _POINTER
    return pointer.exists() and (root / pointer.read_text().strip()).exists()
