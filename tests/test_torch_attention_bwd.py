"""Port flash attention backward (the ``torch.autograd.Function`` in
``distkeras_tpu_torch.ops.attention``) against ``jax.vjp`` of the JAX
package's Pallas flash attention, run in interpret mode on the CPU.

On the CPU the Function runs the plain forward and the plain backward,
which repeat the TPU kernels' arithmetic (f32 logits, ``p = exp(logits -
lse)``, ds and p rounded to the input dtype before their products), so
f32 gradients agree with the Pallas VJP to 2e-5 (summation order only).
bf16 inputs agree to 2e-2 relative to each gradient's largest entry:
the two packages take the same rounding points, but one bf16 ulp of a
rounded ds or p may flip between them.  The CUDA kernels are held
against the plain backward on the card by ``tests/test_torch_cuda.py``
and ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu.ops.attention import flash_attention as jax_flash
from distkeras_tpu_torch.models.transformer import dense_causal_attention
from distkeras_tpu_torch.ops import attention

jax.config.update("jax_platforms", "cpu")
# tiny shapes: one thread each keeps the parallel test workers off
# each other's cores
torch.set_num_threads(1)

TOL = 2e-5       # f32, summation order only
TOL_BF16 = 2e-2  # bf16: relative to the gradient's largest entry


def _inputs(t, d, seed, b=2, h=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, t, h, d)).astype(np.float32)
            for _ in range(4)]


def _jax_vjp(q, k, v, dout, causal, dtype=jnp.float32):
    fn = lambda q, k, v: jax_flash(  # noqa: E731
        q, k, v, causal=causal, block_q=32, block_k=32, interpret=True)
    out, vjp = jax.vjp(fn, *(jnp.asarray(x, dtype) for x in (q, k, v)))
    return out, vjp(jnp.asarray(dout, dtype))


def _port_grads(q, k, v, dout, causal, dtype=torch.float32):
    leaves = [torch.from_numpy(x).to(dtype).requires_grad_()
              for x in (q, k, v)]
    out = attention.flash_attention(*leaves, causal=causal)
    out.backward(torch.from_numpy(dout).to(dtype))
    return out, [x.grad for x in leaves]


@pytest.mark.parametrize("d", [16, 64])
@pytest.mark.parametrize("t", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_backward_matches_jax_vjp(causal, t, d):
    q, k, v, dout = _inputs(t, d, seed=t + d)
    want_out, want = _jax_vjp(q, k, v, dout, causal)
    out, got = _port_grads(q, k, v, dout, causal)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               rtol=TOL, atol=TOL)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float32 and g.shape == q.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL, err_msg=name)


@pytest.mark.parametrize("causal", [True, False])
def test_bf16_backward_rounds_where_jax_does(causal):
    """bf16 in, bf16 gradients out, within 2e-2 of the Pallas VJP's
    (relative to the largest entry).  That the rounding points match
    shows in the bits: at least 70 % of the entries equal JAX's exactly
    (measured 77-100 %), far more than of the exact f32 gradient rounded
    once to bf16 (about 35-43 %)."""
    q, k, v, dout = _inputs(128, 64, seed=11)
    _, want = _jax_vjp(q, k, v, dout, causal, jnp.bfloat16)
    _, got = _port_grads(q, k, v, dout, causal, torch.bfloat16)
    _, exact = _port_grads(q, k, v, dout, causal)
    for name, g, w, e in zip(("dq", "dk", "dv"), got, want, exact):
        assert g.dtype == torch.bfloat16
        w = np.asarray(w.astype(jnp.float32))
        g = g.float().numpy()
        err = np.abs(g - w).max() / np.abs(w).max()
        assert err <= TOL_BF16, (name, err)
        same = (g == w).mean()
        once = (e.bfloat16().float().numpy() == w).mean()
        assert same >= 0.7 and same > once + 0.2, (name, same, once)


def test_plain_backward_is_the_dense_gradient():
    """The Function's CPU backward equals autograd through the port's
    dense causal attention (f32)."""
    q, k, v, dout = (torch.from_numpy(x) for x in _inputs(64, 16, seed=3))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    dense_causal_attention(*leaves, scale=16 ** -0.5).backward(dout)
    _, got = _port_grads(*(x.numpy() for x in (q, k, v, dout)), True)
    for g, want in zip(got, leaves):
        np.testing.assert_allclose(g.numpy(), want.grad.numpy(), rtol=TOL,
                                   atol=TOL)


def test_split_references_compose_to_the_backward():
    q, k, v, dout = (torch.from_numpy(x).transpose(1, 2).contiguous()
                     for x in _inputs(64, 16, seed=4))
    out, lse = attention.flash_attention_reference(q, k, v, scale=0.25)
    dq, dk, dv = attention.flash_attention_bwd_reference(
        q, k, v, out, lse, dout, scale=0.25)
    got = attention.flash_attention_bwd_bhtd(q, k, v, out, lse, dout,
                                             scale=0.25)
    for a, b in zip((dq, dk, dv), got):
        assert torch.equal(a, b)


def test_cpu_backward_counts_no_launch_and_is_first_order():
    q, k, v, dout = (torch.from_numpy(x).requires_grad_()
                     for x in _inputs(32, 8, seed=5))
    counts = (attention.launches, attention.bwd_dq_launches,
              attention.bwd_dkv_launches)
    out = attention.flash_attention(q, k, v)
    (g,) = torch.autograd.grad(out, q, dout, create_graph=True)
    assert counts == (attention.launches, attention.bwd_dq_launches,
                      attention.bwd_dkv_launches)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        g.sum().backward()


def test_gqa_training_sums_the_group_gradients():
    """K/V repeated to the query heads before the kernel, as the JAX
    training path repeats them: each KV head's gradient is the sum over
    its group."""
    rng = np.random.default_rng(6)
    q = torch.from_numpy(rng.standard_normal((1, 32, 4, 8)).astype(
        np.float32))
    kv = [torch.from_numpy(rng.standard_normal((1, 32, 2, 8)).astype(
        np.float32)).requires_grad_() for _ in range(2)]
    out = attention.flash_attention(q, *(x.repeat_interleave(2, dim=2)
                                         for x in kv))
    out.sum().backward()
    reps = [x.detach().repeat_interleave(2, dim=2).requires_grad_()
            for x in kv]
    attention.flash_attention(q, *reps).sum().backward()
    for x, r in zip(kv, reps):
        want = r.grad.view(1, 32, 2, 2, 8).sum(3)
        np.testing.assert_allclose(x.grad.numpy(), want.numpy(), rtol=TOL,
                                   atol=TOL)
