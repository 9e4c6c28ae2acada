"""The port's PS update rules (``distkeras_tpu_torch.parallel.
update_rules``): the cases of ``tests/test_update_rules.py``, and each
rule's commit and pull against the JAX package's on the same numpy
trees."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu.parallel import update_rules as jax_rules
from distkeras_tpu_torch.parallel import ps_emulator
from distkeras_tpu_torch.parallel.update_rules import (
    RULES,
    AdagRule,
    DownpourRule,
    DynSGDRule,
    ElasticRule,
    apply_commit_round,
    apply_commit_round_pulls,
)

torch.set_num_threads(1)


def _params(val=0.0):
    return {"w": torch.full((3,), val), "b": torch.full((2, 2), val)}


def _leaf(tree):
    return tree["w"].numpy()


def _payloads(n):
    return [_params(float(i + 1)) for i in range(n)]


def test_downpour_commit_adds_delta():
    rule = DownpourRule()
    st = rule.commit(rule.init_state(_params(1.0)), _params(0.5), 0)
    np.testing.assert_allclose(_leaf(st.center), 1.5)
    assert st.clock == 1


def test_adag_normalizes_by_window():
    rule = AdagRule()
    delta = rule.normalize_delta(_params(8.0), window=4)
    np.testing.assert_allclose(_leaf(delta), 2.0)
    st = rule.commit(rule.init_state(_params(0.0)), delta, 0)
    np.testing.assert_allclose(_leaf(st.center), 2.0)


def test_dynsgd_scales_by_inverse_staleness():
    rule = DynSGDRule()
    st = rule.commit(rule.init_state(_params(0.0)), _params(1.0), 0)
    np.testing.assert_allclose(_leaf(st.center), 1.0)
    st = rule.commit(st, _params(1.0), 3)  # stale: 1/4 step
    np.testing.assert_allclose(_leaf(st.center), 1.25)


def test_elastic_symmetric_moves():
    rule = ElasticRule(alpha=0.25)
    center0, local = _params(0.0), _params(4.0)
    st = rule.commit(rule.init_state(center0), local, 0)
    np.testing.assert_allclose(_leaf(st.center), 1.0)
    pulled = rule.worker_pull(local, center0, st.center)
    np.testing.assert_allclose(_leaf(pulled), 3.0)


def test_commit_round_matches_sequential_loop():
    rule = DynSGDRule()
    final, pre, post = apply_commit_round(rule, rule.init_state(_params()),
                                          _payloads(5))
    expect = rule.init_state(_params())
    for i, payload in enumerate(_payloads(5)):
        np.testing.assert_allclose(_leaf(pre[i]), _leaf(expect.center))
        expect = rule.commit(expect, payload, i)
        np.testing.assert_allclose(_leaf(post[i]), _leaf(expect.center))
    np.testing.assert_allclose(_leaf(final.center), _leaf(expect.center))
    assert final.clock == 5


def test_commit_round_pulls_matches_stacked_path_delta_rule():
    rule = DynSGDRule()
    st0 = rule.init_state(_params())
    final_a, _, post = apply_commit_round(rule, st0, _payloads(5))
    final_b, pulled = apply_commit_round_pulls(rule, st0, _payloads(5),
                                               None)
    np.testing.assert_allclose(_leaf(final_a.center), _leaf(final_b.center))
    for a, b in zip(pulled, post):
        np.testing.assert_allclose(_leaf(a), _leaf(b))
    assert final_b.clock == 5


def test_commit_round_pulls_matches_stacked_path_elastic_rule():
    rule = ElasticRule(alpha=0.25)
    st0 = rule.init_state(_params())
    payloads = _payloads(4)      # the elastic payload is the local params
    final_a, pre, post = apply_commit_round(rule, st0, payloads)
    final_b, pulled = apply_commit_round_pulls(rule, st0, payloads,
                                               payloads)
    np.testing.assert_allclose(_leaf(final_a.center), _leaf(final_b.center))
    for i, p in enumerate(pulled):
        np.testing.assert_allclose(
            _leaf(p), _leaf(rule.worker_pull(payloads[i], pre[i], post[i])))


def test_elastic_round_closed_form():
    """Center after 4 elastic commits of x=1 from c=0: 1-(1-a)^4."""
    rule = ElasticRule(alpha=0.5)
    final, _, _ = apply_commit_round(rule, rule.init_state(_params()),
                                     [_params(1.0)] * 4)
    np.testing.assert_allclose(_leaf(final.center), 0.9375, rtol=1e-6)


def test_flush_pending_applies_true_commit_depth():
    """The drain applies the final pending commits at their true depth:
    staleness = position in the commit order only, so DynSGD scales
    commit i by 1/(i+1), not 1/(i+1+W)."""
    rule = DynSGDRule()
    n = 4
    final = ps_emulator.flush_pending(rule, rule.init_state(_params()),
                                      _payloads(n), list(range(n)), n)
    np.testing.assert_allclose(_leaf(final.center), 4.0, rtol=1e-6)
    stale = sum((i + 1.0) / (i + 1.0 + n) for i in range(n))
    assert not np.allclose(_leaf(final.center), stale)


@pytest.mark.parametrize("name", sorted(RULES))
def test_each_rule_matches_jax(name):
    """A round of 3 commits at staleness offset 2 from random trees: the
    centers after each commit and each worker's pull, against the JAX
    rule, within f32 rounding."""
    rng = np.random.default_rng(len(name))
    tree = {"w": rng.standard_normal((5, 3)).astype(np.float32),
            "b": rng.standard_normal(4).astype(np.float32)}
    payloads = [{k: rng.standard_normal(v.shape).astype(np.float32)
                 for k, v in tree.items()} for _ in range(3)]
    kw = {"alpha": 0.3} if name in ("aeasgd", "eamsgd") else {}
    jr, pr = getattr(jax_rules, RULES[name].__name__)(**kw), RULES[name](**kw)
    if name == "adag":
        payloads = [jr.normalize_delta(p, 5) for p in payloads]
    stacked = {k: jnp.stack([p[k] for p in payloads]) for k in tree}
    locals_ = stacked if jr.pull_uses_local else None
    jst, jpulled = jax_rules.apply_commit_round_pulls(
        jr, jr.init_state(tree), stacked, locals_, staleness_offset=2)
    tt = {k: torch.tensor(v) for k, v in tree.items()}
    tp = [{k: torch.tensor(np.asarray(v)) for k, v in p.items()}
          for p in payloads]
    pst, ppulled = apply_commit_round_pulls(
        pr, pr.init_state(tt), tp, tp if pr.pull_uses_local else None,
        staleness_offset=2)
    assert pst.clock == int(jst.clock) == 3
    for k in tree:
        np.testing.assert_allclose(pst.center[k].numpy(),
                                   np.asarray(jst.center[k]), rtol=1e-6,
                                   atol=1e-7)
        for i in range(3):
            np.testing.assert_allclose(ppulled[i][k].numpy(),
                                       np.asarray(jpulled[k][i]),
                                       rtol=1e-6, atol=1e-7)
