"""The port's tree arithmetic (``distkeras_tpu_torch.utils``) against the
JAX package's (``distkeras_tpu/utils.py``) on the same seeded f32
trees: each formula keeps the reference's order of operations, so the
two agree to f32 rounding (rtol 1e-6)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu import utils as jax_utils
from distkeras_tpu_torch import utils

jax.config.update("jax_platforms", "cpu")
torch.set_num_threads(1)


def _trees(seed=0):
    rng = np.random.default_rng(seed)
    shapes = {"w": (3, 4), "b": (4,), "s": ()}
    return [{k: rng.standard_normal(s).astype(np.float32)
             for k, s in shapes.items()} for _ in range(2)]


@pytest.mark.parametrize("name,args", [
    ("tree_add", ("a", "b")), ("tree_sub", ("a", "b")),
    ("tree_scale", ("a", 0.3)), ("tree_zeros_like", ("a",)),
    ("tree_axpy", (0.7, "a", "b")), ("tree_lerp", ("a", "b", 0.25))])
def test_tree_op_matches_jax(name, args):
    a, b = _trees()
    trees = {"a": a, "b": b}

    def pick(wrap):
        return [{k: wrap(v) for k, v in trees[x].items()}
                if isinstance(x, str) else x for x in args]

    want = getattr(jax_utils, name)(*pick(jnp.asarray))
    got = getattr(utils, name)(*pick(torch.from_numpy))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)


def test_inputs_are_left_alone():
    a, b = _trees(1)
    ta = {k: torch.from_numpy(v.copy()) for k, v in a.items()}
    tb = {k: torch.from_numpy(v.copy()) for k, v in b.items()}
    out = utils.tree_lerp(ta, tb, 0.5)
    assert all(out[k] is not ta[k] for k in ta)
    for k in a:
        np.testing.assert_array_equal(ta[k].numpy(), a[k])
        np.testing.assert_array_equal(tb[k].numpy(), b[k])
