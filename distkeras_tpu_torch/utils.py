"""The port's copy of ``distkeras_tpu/utils.py``: tree arithmetic over
parameter dicts, parameter and model-config serialization, and the
label and batch helpers.

A "tree" here is a ``dict[str, Tensor]`` (a ``state_dict``), or a dict
of numpy leaves on the host parameter server; every function returns a
new dict of new values and leaves its inputs alone, as the JAX
functions do.  Each formula keeps the reference's order of
operations, so results agree with the JAX package's to f32 rounding.

``serialize_params`` writes the bytes of flax's ``to_bytes`` of the
JAX-layout parameters (``convert.params_to_flax``, dicts in key order as
a JAX tree holds them), so either package reads the other's.
"""

from __future__ import annotations

import json
from typing import Any, Mapping

import numpy as np
import torch

from distkeras_tpu_torch import convert, serialization

Tree = Mapping[str, torch.Tensor]


def tree_add(a: Tree, b: Tree) -> dict:
    return {k: a[k] + b[k] for k in a}


def tree_sub(a: Tree, b: Tree) -> dict:
    return {k: a[k] - b[k] for k in a}


def tree_scale(a: Tree, s) -> dict:
    return {k: x * s for k, x in a.items()}


def tree_zeros_like(a: Tree) -> dict:
    return {k: torch.zeros_like(x) for k, x in a.items()}


def _float_host(x) -> bool:
    return isinstance(x, np.ndarray) and x.dtype.kind == "f"


def tree_axpy(alpha, x: Tree, y: Tree) -> dict:
    """``alpha * x + y``, elementwise over matching trees.  Host numpy
    leaves (the host parameter server's) take ``alpha`` as a scalar of
    the leaf's dtype, as the JAX package's numpy path does."""
    return {k: (x[k].dtype.type(alpha) * x[k] + y[k]
                if _float_host(x[k]) and _float_host(y[k])
                else alpha * x[k] + y[k]) for k in x}


def tree_lerp(a: Tree, b: Tree, t) -> dict:
    """``(1 - t) * a + t * b`` (numpy leaves: both weights as scalars of
    the leaf's dtype, as in ``tree_axpy``)."""
    return {k: (a[k].dtype.type(1.0 - t) * a[k] + a[k].dtype.type(t) * b[k]
                if _float_host(a[k]) and _float_host(b[k])
                else (1.0 - t) * a[k] + t * b[k]) for k in a}


def tree_dot(a: Tree, b: Tree) -> torch.Tensor:
    """Sum of elementwise products over the whole tree (a scalar)."""
    return torch.stack([(a[k] * b[k]).sum() for k in a]).sum()


def tree_l2_norm(a: Tree) -> torch.Tensor:
    return torch.sqrt(tree_dot(a, a))


def tree_size(a: Tree) -> int:
    """Total number of scalars in the tree."""
    return sum(x.numel() for x in a.values())


def tree_cast(a: Tree, dtype) -> dict:
    return {k: x.to(dtype) for k, x in a.items()}


# -- model serialization ------------------------------------------------


def serialize_params(state_dict: Mapping, num_heads: int | None = None
                     ) -> bytes:
    """The port's parameters -> msgpack bytes, those of the JAX
    package's ``serialize_params`` of the same parameters in its layout
    (``num_heads`` for a ``TransformerLM``, as ``params_to_flax``)."""
    return serialization.to_bytes(convert.params_tree(state_dict,
                                                      num_heads))


def deserialize_params(template: Mapping | None, data: bytes) -> dict:
    """msgpack bytes of either package -> the port's ``state_dict``.
    With a ``template`` (a ``state_dict``) the names must match, and
    each value takes the template's dtype and device."""
    sd = convert.params_from_flax(serialization.msgpack_restore(data))
    if template is None:
        return sd
    want = {k for k in template if not convert.is_batch_stat(k)}
    if set(sd) != want:
        raise ValueError(f"parameters differ from the template: extra "
                         f"{sorted(set(sd) - want)}, missing "
                         f"{sorted(want - set(sd))}")
    return {k: v.to(device=template[k].device, dtype=template[k].dtype)
            for k, v in sd.items()}


def serialize_model_config(config: Mapping[str, Any]) -> str:
    """Architecture config dict -> JSON (the analogue of Keras
    ``to_json()``)."""
    return json.dumps(config, sort_keys=True)


def deserialize_model_config(payload: str) -> dict:
    return json.loads(payload)


# -- label and batch helpers ----------------------------------------------


def to_dense_vector(label, num_classes: int) -> np.ndarray:
    """Integer label(s) -> one-hot float32 vector(s)."""
    label = np.asarray(label, dtype=np.int32)
    if label.size and (label.min() < 0 or label.max() >= num_classes):
        raise ValueError(
            f"labels must be in [0, {num_classes}), got range "
            f"[{label.min()}, {label.max()}]")
    return np.eye(num_classes, dtype=np.float32)[label]


def shuffle(arrays: Mapping[str, np.ndarray], seed: int = 0) -> dict:
    """Shuffle a column dict in unison, with the JAX package's
    permutation for the same seed."""
    n = len(next(iter(arrays.values())))
    perm = np.random.default_rng(seed).permutation(n)
    return {k: np.asarray(v)[perm] for k, v in arrays.items()}


def batch_iterator(arrays: Mapping[str, np.ndarray], batch_size: int,
                   drop_remainder: bool = True):
    """Yield dicts of aligned batches from a column dict."""
    n = len(next(iter(arrays.values())))
    stop = (n // batch_size) * batch_size if drop_remainder else n
    for start in range(0, stop, batch_size):
        yield {k: v[start:start + batch_size] for k, v in arrays.items()}


def pad_to_multiple(x: np.ndarray, multiple: int, axis: int = 0
                    ) -> np.ndarray:
    """Pad ``axis`` with zeros up to the next multiple (one shape for
    every call)."""
    rem = (-x.shape[axis]) % multiple
    if rem == 0:
        return x
    pad_width = [(0, 0)] * x.ndim
    pad_width[axis] = (0, rem)
    return np.pad(x, pad_width)
