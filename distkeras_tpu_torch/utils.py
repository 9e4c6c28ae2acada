"""Tree arithmetic over parameter dicts, the port's copy of
``distkeras_tpu/utils.py`` (``tree_add`` ... ``tree_lerp``).

A "tree" here is a ``dict[str, Tensor]`` (a ``state_dict``); every
function returns a new dict of new tensors and leaves its inputs alone,
as the JAX functions do.  Each formula keeps the reference's order of
operations, so results agree with the JAX package's to f32 rounding.
"""

from __future__ import annotations

from typing import Mapping

import torch

Tree = Mapping[str, torch.Tensor]


def tree_add(a: Tree, b: Tree) -> dict:
    return {k: a[k] + b[k] for k in a}


def tree_sub(a: Tree, b: Tree) -> dict:
    return {k: a[k] - b[k] for k in a}


def tree_scale(a: Tree, s) -> dict:
    return {k: x * s for k, x in a.items()}


def tree_zeros_like(a: Tree) -> dict:
    return {k: torch.zeros_like(x) for k, x in a.items()}


def tree_axpy(alpha, x: Tree, y: Tree) -> dict:
    """``alpha * x + y``, elementwise over matching trees."""
    return {k: alpha * x[k] + y[k] for k in x}


def tree_lerp(a: Tree, b: Tree, t) -> dict:
    """``(1 - t) * a + t * b``."""
    return {k: (1.0 - t) * a[k] + t * b[k] for k in a}
