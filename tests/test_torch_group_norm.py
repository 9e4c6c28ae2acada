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


# the PS path's GroupNorm shapes: ResNet-50 at 224 px, batch 32, 32
# groups ([HW, C] of its 53 GroupNorms a step)
PATH_SHAPES = [(32, hw, c, 32) for hw, c in (
    (12544, 64), (3136, 64), (3136, 128), (3136, 256), (784, 128),
    (784, 256), (784, 512), (196, 256), (196, 512), (196, 1024), (49, 512),
    (49, 2048))]

# cudaOccupancyMaxActiveClusters of the one-pass kernels on an NVIDIA
# H100 80GB HBM3 (132 SMs), by cluster size: two blocks an SM where a
# block takes at most 115,712 bytes of shared memory (half the SM's
# 233,472 less 1 KB a block), else one; the same at every shape,
# direction, dtype and split count
H100_CLUSTERS = {2: {1: 264, 2: 132, 4: 62, 8: 30},
                 1: {1: 132, 2: 66, 4: 30, 8: 15}}


def h100(k, splits, rows, smem):
    return H100_CLUSTERS[2 if smem <= 115_712 else 1][k]


# (splits, k) that ``launch_plan`` launches on that card, forward and
# backward, bf16
H100_PLANS = {
    (49, 512): ((4, 1), (4, 1)), (196, 256): ((4, 1), (4, 1)),
    (49, 2048): ((4, 1), (4, 1)), (196, 512): ((4, 1), (4, 1)),
    (784, 128): ((4, 1), (4, 1)), (196, 1024): ((4, 1), (4, 1)),
    (784, 256): ((4, 1), (4, 1)), (3136, 64): ((2, 2), (2, 2)),
    (784, 512): ((4, 1), (8, 1)), (3136, 128): ((4, 1), (4, 2)),
    (3136, 256): ((8, 1), (8, 2)), (12544, 64): ((2, 8), (2, 8))}


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
@pytest.mark.parametrize("shape", PATH_SHAPES)
def test_plan_takes_the_one_pass_route_on_the_ps_path(shape, direction):
    """Every bf16 GroupNorm of the PS path runs in one launch on the
    H100: channel splits in clusters within the portable limit, whose
    blocks together hold the image and each fit the shared memory of
    one block."""
    b, hw, c, g = shape
    plan = gn.gn_plan(b, hw, c, g, torch.bfloat16, direction,
                      capacity=h100)
    assert plan.route == "one_pass"
    assert (plan.splits, plan.k) == \
        H100_PLANS[hw, c][direction == "bwd"]
    assert 1 <= plan.k <= gn.KMAX
    assert plan.k & (plan.k - 1) == 0
    assert plan.rows == -(-hw // plan.k)
    inputs = 1 if direction == "fwd" else 2
    assert plan.smem <= gn.SMEM_PER_BLOCK
    assert plan.smem >= inputs * plan.rows * c // plan.splits * 2
    assert plan.scratch == 0


def test_plan_cuts_the_largest_path_images_into_channel_splits():
    """The 1.6 MB bf16 images (the stem and [3136, 256]; x and dy 3.2 MB
    in the backward) go as channel splits, no cluster over 8 blocks, in
    the fewest waves the H100 allows."""
    waves = {}
    for hw, c in ((12544, 64), (3136, 256)):
        for d in ("fwd", "bwd"):
            plan = gn.gn_plan(32, hw, c, 32, torch.bfloat16, d,
                              capacity=h100)
            assert plan.splits > 1 and plan.k <= 8
            waves[hw, c, d] = -(-32 * plan.splits // h100(
                plan.k, plan.splits, plan.rows, plan.smem))
    assert waves == {(12544, 64, "fwd"): 3, (12544, 64, "bwd"): 5,
                     (3136, 256, "fwd"): 2, (3136, 256, "bwd"): 4}


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_images_no_cluster_holds_take_the_two_pass_route(direction):
    """f32 at the stem fits the H100 as 4 splits of 16 channels in
    clusters of 8; a 448-pixel stem ([50176, 64], 6.4 MB of bf16 x an
    image) fits no launch, so it runs as statistics, fold and apply
    grids over row tiles, with scratch for the tiles' partials (and the
    folded group terms)."""
    f32 = gn.gn_plan(4, 12544, 64, 32, torch.float32, direction,
                     capacity=h100)
    assert (f32.route, f32.splits, f32.k) == ("one_pass", 4, 8)
    plan = gn.gn_plan(2, 50176, 64, 32, torch.bfloat16, direction,
                      capacity=h100)
    assert plan.route == "two_pass" and plan.k == 0 and plan.smem == 0
    assert plan.rows == gn.TILE_ELEMS // 64
    tiles = -(-50176 // plan.rows)
    want = 2 * tiles * 2 * 32 if direction == "fwd" \
        else 2 * tiles * 2 * 64 + 2 * 2 * 32
    assert plan.scratch == want


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_rows_off_the_16_byte_vector_take_the_two_pass_route(direction):
    assert gn.gn_plan(2, 25, 12, 4, torch.bfloat16, direction,
                      capacity=h100).route == "two_pass"
    assert gn.gn_plan(2, 25, 12, 4, torch.float32, direction,
                      capacity=h100).route == "one_pass"
    assert gn.gn_plan(32, 49, 512, 32, torch.bfloat16, direction,
                      capacity=h100, aligned=False).route == "two_pass"


def test_plan_counts_the_block_as_the_source_lays_it_out():
    """``[32, 12544, 64]`` bf16 forward at k 8, unsplit: 1568 rows of
    128 bytes; the fold buffer for the 8 warps' row lanes but the first
    (the 4 row lanes of a warp fold by shuffles), 2 x 7 x 64 channels
    f32; 2C + 2G + 2kG f32 of statistics and inboxes."""
    plan = gn.gn_plan(32, 12544, 64, 32, torch.bfloat16, "fwd", k=8,
                      splits=1, capacity=h100)
    assert (plan.k, plan.rows, plan.splits) == (8, 1568, 1)
    assert plan.smem == (1568 * 128 + 4 * 2 * 7 * 64
                         + 4 * (2 * 64 + 2 * 32 + 2 * 8 * 32))
    # the backward as the H100 launches it, 2 splits of 32 channels (16
    # groups) at k 8: x and dy, 1568 rows of 64 bytes each; the row
    # lanes of a warp's 4 channel vectors fold by shuffles to 8 lanes;
    # 2C + 2G + 2kG + 2k ceil(C / k)
    plan = gn.gn_plan(32, 12544, 64, 32, torch.bfloat16, "bwd",
                      capacity=h100)
    assert (plan.splits, plan.k, plan.rows) == (2, 8, 1568)
    assert plan.smem == (2 * 1568 * 64 + 4 * 2 * 7 * 32
                         + 4 * (2 * 32 + 2 * 16 + 2 * 8 * 16
                                + 2 * 8 * 4))
    # 2048 channels: one row lane a chunk, no fold buffer
    plan = gn.gn_plan(32, 49, 2048, 32, torch.bfloat16, "fwd", k=2,
                      splits=1, capacity=h100)
    assert plan.smem == (25 * 4096 + 4 * (2 * 2048 + 2 * 32 + 2 * 2 * 32))
    # 4 channel splits of [3136, 256] at k 2: 1568 rows of 64 channels
    # (8 groups) a block
    plan = gn.gn_plan(32, 3136, 256, 32, torch.bfloat16, "fwd", k=2,
                      splits=4, capacity=h100)
    assert (plan.rows, plan.splits) == (1568, 4)
    assert plan.smem == (1568 * 128 + 4 * 2 * 7 * 64
                         + 4 * (2 * 64 + 2 * 8 + 2 * 2 * 8))


def test_plan_takes_the_fewest_waves_the_card_allows():
    """Given the card's clusters at once, the plan takes the cluster size
    with the fewest waves, then the one whose waves come nearest
    ``WAVE_BLOCKS`` blocks, then the smaller, and skips a size the card
    cannot schedule (here without channel splits)."""
    def capacity(table):
        return lambda k, splits, rows, smem: table[k] if splits == 1 else 0

    shape = (32, 196, 1024, 32, torch.bfloat16, "fwd")
    # k 1 does not hold the rows; 30 clusters of 2 at once leave two of
    # 32 for a second wave, 45 of 4 or of 8 take them all and clusters
    # of 4 make 128 blocks
    assert gn.gn_plan(*shape, capacity=capacity(
        {1: 0, 2: 30, 4: 45, 8: 45})).k == 4
    # one wave at every size: 64 blocks of 2 and 128 of 4 lie as near
    # 128 (a factor of 2 each side from 256 and 64): the smaller k
    assert gn.gn_plan(*shape, capacity=capacity(
        {1: 0, 2: 32, 4: 45, 8: 45})).k == 4
    assert gn.gn_plan(*shape, capacity=capacity(
        {1: 0, 2: 32, 4: 0, 8: 45})).k == 2
    assert gn.gn_plan(*shape, capacity=capacity(
        {1: 0, 2: 0, 4: 0, 8: 0})).route == "two_pass"
    # a forced size is taken as it is, without asking the card
    assert gn.gn_plan(*shape, k=4, capacity=None).k == 4


def test_plan_cuts_an_image_into_channel_splits_for_fewer_waves():
    """Splits of whole groups are clusters of their own: with the card
    holding 15 clusters of 8, 30 of 4, 66 of 2 and 132 of 1 at one block
    an SM, [32, 3136, 256] forward takes 3 waves unsplit and 2 as 4
    splits of 64 channels in clusters of 2 (blocks of 196 KB either
    way), or as 8 of 32 channels in blocks of their own."""
    table = H100_CLUSTERS[1]
    plan = gn.gn_plan(32, 3136, 256, 32, torch.bfloat16, "fwd",
                      capacity=lambda k, splits, rows, smem: table[k])
    assert (plan.splits, plan.k) in {(4, 2), (8, 1)}
    assert -(-32 * plan.splits // table[plan.k]) == 2
    # a split keeps at least 64 bytes of a row: the stem's 64 bf16
    # channels split at most 2 ways
    stem = gn.gn_plan(32, 12544, 64, 32, torch.bfloat16, "fwd",
                      capacity=lambda k, splits, rows, smem: table[k])
    assert stem.splits <= 2
    with pytest.raises(ValueError):
        gn.gn_plan(32, 12544, 64, 32, torch.bfloat16, "fwd", k=4,
                   splits=4, capacity=h100)


def test_plan_can_be_forced_to_either_route():
    two = gn.gn_plan(32, 49, 512, 32, "bfloat16", "bwd", route="two_pass",
                     capacity=h100)
    assert two.route == "two_pass" and two.scratch > 0
    one = gn.gn_plan(32, 49, 512, 32, "bfloat16", "bwd", k=2,
                     capacity=h100)
    assert (one.route, one.k, one.rows) == ("one_pass", 2, 25)


def test_an_unforced_plan_needs_the_card_capacity():
    """There is one planner: without the card's capacity no plan is
    chosen."""
    with pytest.raises(TypeError):
        gn.gn_plan(32, 49, 512, 32, torch.bfloat16, "fwd")
    with pytest.raises(TypeError):
        gn.gn_plan(32, 49, 512, 32, torch.bfloat16, "fwd", capacity=None)


@pytest.mark.parametrize("args,kw", [
    ((32, 49, 500, 32, torch.bfloat16, "fwd"), {}),          # C % G
    ((32, 49, 8192, 32, torch.bfloat16, "fwd"), {}),         # too wide
    ((0, 49, 512, 32, torch.bfloat16, "fwd"), {}),           # empty
    ((32, 0, 512, 32, torch.bfloat16, "bwd"), {}),
    ((32, 49, 512, 32, torch.bfloat16, "sideways"), {}),     # direction
    ((32, 49, 512, 32, torch.bfloat16, "fwd"), {"route": "three_pass"}),
    # a one-pass launch the shape cannot take
    ((2, 50176, 64, 32, torch.bfloat16, "fwd"), {"route": "one_pass"}),
    ((32, 3136, 256, 32, torch.bfloat16, "bwd"), {"k": 8}),
    ((32, 49, 512, 32, torch.bfloat16, "fwd"), {"k": 32}),
    # over the portable limit of 8
    ((32, 12544, 64, 32, torch.bfloat16, "bwd"), {"k": 16, "splits": 2}),
    ((32, 49, 512, 32, torch.bfloat16, "fwd"),
     {"k": 4, "route": "two_pass"}),
    ((2, 25, 12, 4, torch.bfloat16, "fwd"), {"route": "one_pass"}),
])
def test_plan_raises_on_a_shape_or_launch_it_cannot_take(args, kw):
    with pytest.raises(ValueError):
        gn.gn_plan(*args, capacity=h100, **kw)


def test_plan_raises_on_a_dtype_the_kernels_do_not_take():
    with pytest.raises(TypeError):
        gn.gn_plan(32, 49, 512, 32, torch.float16, "fwd", capacity=h100)


def test_cpu_tensors_count_no_route():
    x, gamma, beta, _ = _inputs()
    before = dict(gn.route_launches)
    assert set(before) == {"fwd_one_pass", "fwd_two_pass", "bwd_one_pass",
                           "bwd_two_pass"}
    xt = torch.tensor(x, requires_grad=True)
    _fused_group_norm(xt, torch.tensor(gamma), torch.tensor(beta),
                      groups=4, relu=True).sum().backward()
    assert gn.route_launches == before
