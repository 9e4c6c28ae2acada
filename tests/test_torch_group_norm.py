"""The port's GroupNorm (``distkeras_tpu_torch.ops.group_norm``) against
the JAX package's ``fused_group_norm`` (``ops/pallas_kernels.py``),
which runs its Pallas kernels in interpret mode off the TPU.  On the CPU
the port runs the kernels' plain versions, forward and backward, under
the same ``torch.autograd.Function`` the card's kernels run under.

Inputs are drawn with numpy and handed to both.  Tolerances: f32 1e-5
for the forward and rtol 1e-4 / atol 1e-5 for the gradients, the JAX
package's own limits for its kernel (``tests/test_pallas_kernels.py``);
bf16 one bf16 ulp of |y| (2^-7 relative), for a value rounded to the
neighbouring one where the two sum in another order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu.ops.pallas_kernels import fused_group_norm as jax_gn
from distkeras_tpu_torch.ops import group_norm as gn

jax.config.update("jax_platforms", "cpu")
# tiny shapes: one thread each keeps the parallel test workers off
# each other's cores
torch.set_num_threads(1)


def _fused_group_norm(x, gamma, beta, *, groups, eps=1e-6, relu=False):
    """The JAX ``fused_group_norm`` contract on the port: ``x [B, ..., C]``
    (channels last, contiguous), ``gamma``/``beta`` [C] f32."""
    return gn.group_norm(x.movedim(-1, 1), gamma, beta, groups=groups,
                         eps=eps, relu=relu).movedim(1, -1)


def _inputs(c=16, seed=0, shape=(2, 4, 4)):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((*shape, c)) * 2 + 0.5).astype(np.float32)
    gamma = (rng.standard_normal(c) * 0.5 + 1.0).astype(np.float32)
    beta = (rng.standard_normal(c) * 0.1).astype(np.float32)
    cot = rng.standard_normal((*shape, c)).astype(np.float32)
    return x, gamma, beta, cot


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("groups", [4, 8])
def test_forward_matches_jax(groups, relu):
    x, gamma, beta, _ = _inputs()
    want = np.asarray(jax_gn(jnp.asarray(x), jnp.asarray(gamma),
                             jnp.asarray(beta), groups=groups, relu=relu))
    got = _fused_group_norm(torch.tensor(x), torch.tensor(gamma),
                              torch.tensor(beta), groups=groups, relu=relu)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("groups", [4, 8])
def test_backward_matches_jax(groups, relu):
    """The ``_GroupNorm`` backward (x, gamma and beta) against
    ``jax.grad`` through the JAX package's custom VJP, for a cotangent
    that is not all ones."""
    x, gamma, beta, cot = _inputs(seed=groups)

    def loss(x, g, b):
        return jnp.sum(jax_gn(x, g, b, groups=groups, relu=relu) * cot)

    want = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta))
    xt, gt, bt = (torch.tensor(a, requires_grad=True)
                  for a in (x, gamma, beta))
    y = _fused_group_norm(xt, gt, bt, groups=groups, relu=relu)
    (y * torch.tensor(cot)).sum().backward()
    for got, w in zip((xt.grad, gt.grad, bt.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("relu", [False, True])
def test_bf16_forward_within_one_ulp(relu):
    x, gamma, beta, _ = _inputs(seed=3)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(jax_gn(xb, jnp.asarray(gamma), jnp.asarray(beta),
                             groups=4, relu=relu), np.float32)
    got = _fused_group_norm(torch.tensor(x).bfloat16(),
                              torch.tensor(gamma), torch.tensor(beta),
                              groups=4, relu=relu)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert (np.abs(got - want) <= 2 ** -7 * np.abs(want) + 1e-6).all()


def test_plain_versions_match_the_jax_kernel_outputs():
    """``group_norm_fwd_reference`` returns the kernel's statistics too:
    mean and inv-std per (image, group), as the TPU kernel writes them
    (``[B, 1, G]`` there, ``[B, G]`` here)."""
    from distkeras_tpu.ops.pallas_kernels import _fwd_call, _group_mask

    x, gamma, beta, _ = _inputs(seed=5)
    x3 = x.reshape(2, 16, 16)
    y, mean, inv = _fwd_call(jnp.asarray(x3), jnp.asarray(gamma)[None],
                             jnp.asarray(beta)[None],
                             jnp.asarray(_group_mask(16, 4)), eps=1e-6,
                             relu=True, interpret=True)
    got = gn.group_norm_fwd_reference(torch.tensor(x3), torch.tensor(gamma),
                                      torch.tensor(beta), groups=4,
                                      relu=True)
    for a, w in zip(got, (y, mean, inv)):
        np.testing.assert_allclose(a.numpy(), np.asarray(w).reshape(a.shape),
                                   rtol=1e-5, atol=1e-5)


def test_indivisible_groups_raise():
    x, gamma, beta, _ = _inputs(c=10)
    with pytest.raises(ValueError, match="not divisible"):
        _fused_group_norm(torch.tensor(x), torch.tensor(gamma),
                            torch.tensor(beta), groups=4)
    with pytest.raises(ValueError):
        jax_gn(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta),
               groups=4)


def test_incoming_gradient_in_another_layout_is_copied_once():
    """The model's layout is channels-last ``[B, C, H, W]``; a gradient
    arriving contiguous in NCHW is made channels-last by one counted
    copy, and the result is the same."""
    x, gamma, beta, cot = _inputs(seed=6)
    x4 = torch.tensor(x).permute(0, 3, 1, 2).requires_grad_()
    g, b = torch.tensor(gamma), torch.tensor(beta)
    before = gn.gradient_copies
    y = gn.group_norm(x4, g, b, groups=4)
    assert y.is_contiguous(memory_format=torch.channels_last)
    dy = torch.tensor(cot).permute(0, 3, 1, 2).contiguous()   # NCHW
    (dx,) = torch.autograd.grad(y, x4, dy)
    assert gn.gradient_copies == before + 1
    x5 = torch.tensor(x).requires_grad_()
    y5 = _fused_group_norm(x5, g, b, groups=4)
    (dx5,) = torch.autograd.grad(y5, x5, torch.tensor(cot))
    assert gn.gradient_copies == before + 1
    np.testing.assert_allclose(dx.permute(0, 2, 3, 1).numpy(), dx5.numpy(),
                               rtol=1e-6, atol=1e-6)


def test_cpu_tensors_launch_no_kernel():
    x, gamma, beta, _ = _inputs()
    before = (gn.fwd_launches, gn.bwd_launches)
    xt = torch.tensor(x, requires_grad=True)
    _fused_group_norm(xt, torch.tensor(gamma), torch.tensor(beta),
                        groups=4).sum().backward()
    assert (gn.fwd_launches, gn.bwd_launches) == before
