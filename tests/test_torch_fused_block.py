"""The port's fused bottleneck regions (``distkeras_tpu_torch.ops.
fused_block``) and its fused ResNet against the JAX package's
(``ops/fused_block.py``, ``models/resnet.py``), whose Pallas kernels run
in interpret mode off the TPU.  On the CPU the port runs the kernels'
plain versions, forward and backward, under the same
``torch.autograd.Function``s the card's kernels run under.

Inputs are drawn with numpy and handed to both; JAX's products are
pinned to float32 as its own tests pin them.  Tolerances: f32 forward
1e-5 and gradients rtol 1e-4 / atol 1e-5 (the JAX package's limits for
these kernels against their oracles, ``tests/test_fused_block.py``;
here the two sides differ by summation order only); bf16 per element
2^-7 of |want| + rms(want), one bf16 ulp, for a value rounded to the
neighbouring one where the two sum in another order.  Whole models: a
conv's output on XLA:CPU depends on the batch shape (ROADMAP §3), so
logits within 1e-4 of their rms and each parameter's gradient within
1e-3 of its norm (floor: 1e-3 of the whole gradient's)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu.models import ModelSpec
from distkeras_tpu.models import model_config as jax_config
from distkeras_tpu.ops import fused_block as jfb
from distkeras_tpu_torch import build_model, convert
from distkeras_tpu_torch.models import model_config
from distkeras_tpu_torch.models.resnet import (AdaptiveGroupNorm,
                                               BottleneckBlock,
                                               FusedBottleneckBlock)
from chip_smoke import _map_block_params
from distkeras_tpu_torch.ops import fused_block as fb

jax.config.update("jax_platforms", "cpu")
# tiny shapes: one thread each keeps the parallel test workers off
# each other's cores
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _f32_matmuls():
    with jax.default_matmul_precision("float32"):
        yield


def _rand(rng, shape, scale=1.0, shift=0.0):
    return (rng.standard_normal(shape) * scale + shift).astype(np.float32)


def _img(a, dtype=torch.float32, grad=False):
    """NHWC numpy -> the port's channels-last ``[B, C, H, W]`` view."""
    t = torch.tensor(a).to(dtype).permute(0, 3, 1, 2)
    return t.detach().requires_grad_() if grad else t


def _nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def _conv_inputs(seed, shape=(2, 4, 4), cin=8, cout=16):
    rng = np.random.default_rng(seed)
    return (_rand(rng, (*shape, cin)), _rand(rng, (cin, cout), 0.3),
            _rand(rng, (cout,), 0.5, 1.0), _rand(rng, (cout,), 0.1),
            _rand(rng, (*shape, cout)))


def _tail_inputs(seed, shape=(2, 4, 4), cm=8, cout=16):
    rng = np.random.default_rng(seed)
    return (_rand(rng, (*shape, cm)), _rand(rng, (cm, cout), 0.3),
            _rand(rng, (cm,), 0.3, 1.0), _rand(rng, (cm,), 0.1),
            _rand(rng, (cout,), 0.3, 0.5), _rand(rng, (cout,), 0.1),
            _rand(rng, (*shape, cout)), _rand(rng, (*shape, cout)))


@pytest.mark.parametrize("relu", [True, False])
def test_conv_gn_forward_matches_jax(relu):
    x, w, g, b, _ = _conv_inputs(0)
    want = np.asarray(jfb.fused_conv1x1_gn(x, w, g, b, groups=4, relu=relu))
    got = fb.fused_conv1x1_gn(_img(x), torch.tensor(w), torch.tensor(g),
                              torch.tensor(b), groups=4, relu=relu)
    assert got.shape == (2, 16, 4, 4)
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(_nhwc(got), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("relu", [True, False])
def test_conv_gn_vjp_matches_jax(relu):
    """All four gradients against ``jax.grad`` through the JAX custom VJP,
    for a cotangent that is not all ones."""
    x, w, g, b, cot = _conv_inputs(1 + relu)

    def loss(*a):
        return jnp.sum(jfb.fused_conv1x1_gn(*a, groups=4, relu=relu) * cot)

    want = jax.grad(loss, argnums=(0, 1, 2, 3))(x, w, g, b)
    xt = _img(x, grad=True)
    wt, gt, bt = (torch.tensor(a, requires_grad=True) for a in (w, g, b))
    y = fb.fused_conv1x1_gn(xt, wt, gt, bt, groups=4, relu=relu)
    (y * _img(cot)).sum().backward()
    got = (_nhwc(xt.grad), wt.grad.numpy(), gt.grad.numpy(),
           bt.grad.numpy())
    for name, a, ww in zip(("dx", "dw", "dgamma", "dbeta"), got, want):
        np.testing.assert_allclose(a, np.asarray(ww), rtol=1e-4, atol=1e-5,
                                   err_msg=name)


def _jax_tail(y2, w, g2, b2, g3, b3, res):
    return jfb.fused_bottleneck_tail(y2, w, g2, b2, g3, b3, res, groups2=4,
                                     groups3=4)


def test_tail_forward_matches_jax():
    y2, w, g2, b2, g3, b3, res, _ = _tail_inputs(3)
    want = np.asarray(_jax_tail(y2, w, g2, b2, g3, b3, res))
    got = fb.fused_bottleneck_tail(
        _img(y2), *(torch.tensor(a) for a in (w, g2, b2, g3, b3)),
        _img(res), groups2=4, groups3=4)
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(_nhwc(got), want, rtol=1e-5, atol=1e-5)


def test_tail_vjp_matches_jax():
    """All seven gradients, the residual's included."""
    y2, w, g2, b2, g3, b3, res, cot = _tail_inputs(4)

    def loss(*a):
        return jnp.sum(_jax_tail(*a) * cot)

    want = jax.grad(loss, argnums=tuple(range(7)))(y2, w, g2, b2, g3, b3,
                                                   res)
    y2t, rest = _img(y2, grad=True), _img(res, grad=True)
    params = [torch.tensor(a, requires_grad=True)
              for a in (w, g2, b2, g3, b3)]
    out = fb.fused_bottleneck_tail(y2t, *params, rest, groups2=4, groups3=4)
    (out * _img(cot)).sum().backward()
    got = [_nhwc(y2t.grad)] + [p.grad.numpy() for p in params] \
        + [_nhwc(rest.grad)]
    for name, a, ww in zip(("dy2", "dw", "dg2", "db2", "dg3", "db3",
                            "dres"), got, want):
        np.testing.assert_allclose(a, np.asarray(ww), rtol=1e-4, atol=1e-5,
                                   err_msg=name)


def _ulp_ok(got, want):
    got, want = got.astype(np.float32), np.asarray(want, np.float32)
    rms = np.sqrt(np.mean(want ** 2))
    return (np.abs(got - want) <= 2 ** -7 * (np.abs(want) + rms)).all()


def test_bf16_inputs_give_bf16_outputs():
    x, w, g, b, _ = _conv_inputs(5, shape=(2, 8, 8))
    bf = jnp.bfloat16
    want = jfb.fused_conv1x1_gn(jnp.asarray(x, bf), jnp.asarray(w, bf), g, b,
                                groups=4)
    got = fb.fused_conv1x1_gn(_img(x, torch.bfloat16),
                              torch.tensor(w).bfloat16(), torch.tensor(g),
                              torch.tensor(b), groups=4)
    assert got.dtype == torch.bfloat16 and want.dtype == bf
    assert _ulp_ok(_nhwc(got), want)
    y2, w, g2, b2, g3, b3, res, _ = _tail_inputs(6, shape=(2, 8, 8))
    want = _jax_tail(jnp.asarray(y2, bf), jnp.asarray(w, bf), g2, b2, g3, b3,
                     jnp.asarray(res, bf))
    got = fb.fused_bottleneck_tail(
        _img(y2, torch.bfloat16), torch.tensor(w).bfloat16(),
        *(torch.tensor(a) for a in (g2, b2, g3, b3)),
        _img(res, torch.bfloat16), groups2=4, groups3=4)
    assert got.dtype == torch.bfloat16
    assert _ulp_ok(_nhwc(got), want)


def test_bf16_parameter_gradient_is_rounded_as_jax_rounds_it():
    """In a bf16 model the kernel gets ``w.astype(bf16)``: its gradient is
    rounded to bf16 before the cast back to the f32 parameter, in both
    packages; the port's autograd through ``.to(dtype)`` gives the same."""
    x, w, g, b, cot = _conv_inputs(7)
    jd, td = jnp.bfloat16, torch.bfloat16

    def loss(w32):
        y = jfb.fused_conv1x1_gn(jnp.asarray(x, jd), w32.astype(jd), g, b,
                                 groups=4)
        return jnp.sum(y.astype(jnp.float32) * cot)

    want = np.asarray(jax.grad(loss)(jnp.asarray(w)))
    wt = torch.tensor(w, requires_grad=True)
    y = fb.fused_conv1x1_gn(_img(x, td), wt.to(td), torch.tensor(g),
                            torch.tensor(b), groups=4)
    (y.float() * _img(cot)).sum().backward()
    # both sides' gradients are bf16 values
    assert np.array_equal(want, want.astype(jnp.bfloat16).astype(np.float32))
    got = wt.grad.numpy()
    assert np.array_equal(got, torch.tensor(got).bfloat16().float().numpy())
    assert _ulp_ok(got, want)


def test_plain_versions_match_the_jax_kernel_outputs():
    """The plain forward and backward against the TPU kernels' own
    outputs (``_conv_gn``/``_conv_gn_bwd``, ``_tail``/``_tail_bwd``,
    interpret mode): the weight gradient is f32 summed over the images,
    dgamma and dbeta summed too."""
    x, w, g, b, dy = _conv_inputs(8)
    x3, dy3 = x.reshape(2, 16, 8), dy.reshape(2, 16, 16)
    args = (jnp.asarray(x3), jnp.asarray(w), jnp.asarray(g)[None],
            jnp.asarray(b)[None])
    want_y = jfb._conv_gn(*args, 4, 1e-6, True, True)
    want_b = jfb._conv_gn_bwd(4, 1e-6, True, True, args, jnp.asarray(dy3))
    t = [torch.tensor(a) for a in (x3, w, g, b)]
    got_y = fb.conv1x1_gn_fwd_reference(*t, groups=4)
    got_b = fb.conv1x1_gn_bwd_reference(*t, torch.tensor(dy3), groups=4)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), rtol=1e-5,
                               atol=1e-5)
    for a, ww in zip(got_b, want_b):
        np.testing.assert_allclose(a.numpy(), np.asarray(ww).reshape(a.shape),
                                   rtol=1e-4, atol=1e-5)

    y2, w, g2, b2, g3, b3, res, dout = _tail_inputs(9)
    r = lambda a: a.reshape(2, 16, -1)                       # noqa: E731
    args = (jnp.asarray(r(y2)), jnp.asarray(w),
            *(jnp.asarray(a)[None] for a in (g2, b2, g3, b3)),
            jnp.asarray(r(res)))
    want_o = jfb._tail(*args, 4, 4, 1e-6, True)
    want_b = jfb._tail_bwd(4, 4, 1e-6, True, args, jnp.asarray(r(dout)))
    t = [torch.tensor(a) for a in (r(y2), w, g2, b2, g3, b3, r(res))]
    got_o = fb.bottleneck_tail_fwd_reference(*t, groups2=4, groups3=4)
    got_b = fb.bottleneck_tail_bwd_reference(*t, torch.tensor(r(dout)),
                                             groups2=4, groups3=4)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), rtol=1e-5,
                               atol=1e-5)
    for a, ww in zip(got_b, want_b):
        np.testing.assert_allclose(a.numpy(), np.asarray(ww).reshape(a.shape),
                                   rtol=1e-4, atol=1e-5)


def test_cpu_tensors_launch_no_kernel():
    before = (fb.conv_gn_fwd_launches, fb.conv_gn_bwd_launches,
              fb.tail_fwd_launches, fb.tail_bwd_launches)
    x, w, g, b, _ = _conv_inputs(10)
    xt = _img(x, grad=True)
    y = fb.fused_conv1x1_gn(xt, torch.tensor(w), torch.tensor(g),
                            torch.tensor(b), groups=4)
    out = fb.fused_bottleneck_tail(
        y[:, :8], torch.tensor(w), torch.tensor(g[:8]), torch.tensor(b[:8]),
        torch.tensor(g), torch.tensor(b), y, groups2=4, groups3=4)
    out.sum().backward()
    assert xt.grad is not None
    assert (fb.conv_gn_fwd_launches, fb.conv_gn_bwd_launches,
            fb.tail_fwd_launches, fb.tail_bwd_launches) == before


def test_wrong_shapes_and_groups_raise():
    x, w, g, b, _ = _conv_inputs(11)
    with pytest.raises(ValueError, match="not divisible"):
        fb.fused_conv1x1_gn(_img(x), torch.tensor(w), torch.tensor(g),
                            torch.tensor(b), groups=3)
    with pytest.raises(ValueError, match="channels"):
        fb.fused_conv1x1_gn(_img(x)[:, :4], torch.tensor(w),
                            torch.tensor(g), torch.tensor(b), groups=4)
    with pytest.raises(ValueError, match="f32"):
        fb.fused_conv1x1_gn(_img(x), torch.tensor(w),
                            torch.tensor(g).double(), torch.tensor(b),
                            groups=4)


def test_channels_last_copies_once_and_counts_it():
    x = torch.randn(2, 8, 6, 6).contiguous(memory_format=torch.channels_last)
    before = fb.input_copies
    assert fb.channels_last(x) is x
    assert fb.input_copies == before
    xs = fb.channels_last(x[:, :, ::2, ::2])
    assert fb.input_copies == before + 1
    assert xs.movedim(1, -1).is_contiguous()
    assert torch.equal(xs, x[:, :, ::2, ::2])


def test_incoming_gradient_in_another_layout_is_copied_once():
    x, w, g, b, cot = _conv_inputs(12)
    args = (torch.tensor(w), torch.tensor(g), torch.tensor(b))
    x4 = _img(x, grad=True)
    before = fb.gradient_copies
    y = fb.fused_conv1x1_gn(x4, *args, groups=4)
    dy = _img(cot).contiguous()                              # NCHW
    (dx,) = torch.autograd.grad(y, x4, dy)
    assert fb.gradient_copies == before + 1
    x5 = _img(x, grad=True)
    (dx5,) = torch.autograd.grad(fb.fused_conv1x1_gn(x5, *args, groups=4),
                                 x5, _img(cot))
    assert fb.gradient_copies == before + 1
    np.testing.assert_allclose(dx.numpy(), dx5.numpy(), rtol=1e-6, atol=1e-6)


# ---- the bf16 backwards' pass plans (ops/fused_block.py bwd_plan) ------


def _resnet50_calls(batch=256):
    """The fused calls of one ResNet-50 step (stages 3-4-6-3, widths 64
    to 512, 224 px with the s2d stem: 56x56 into the first stage; the
    stride in each first block's 3x3 conv), as ``fusion="pallas_block"``
    makes them: conv keys (B, HW, Cin, Cout, G, relu), tail keys (B, HW,
    Cm, Cout, G2, G3), with repeats."""
    conv, tail = [], []
    cin, hw = 64, 56 * 56
    for i, (blocks, width) in enumerate(zip((3, 4, 6, 3),
                                            (64, 128, 256, 512))):
        out_hw = hw if i == 0 else hw // 4
        for j in range(blocks):
            conv.append((batch, hw if j == 0 else out_hw, cin, width, 32,
                         True))
            if j == 0:
                conv.append((batch, out_hw, cin, 4 * width, 32, False))
            tail.append((batch, out_hw, width, 4 * width, 32, 32))
            cin = 4 * width
        hw = out_hw
    return conv, tail


CONV_CALLS, TAIL_CALLS = _resnet50_calls()


def test_the_path_has_20_conv_and_16_tail_calls():
    assert len(CONV_CALLS) == 20 and len(TAIL_CALLS) == 16
    assert len(set(CONV_CALLS)) == 12 and len(set(TAIL_CALLS)) == 4
    # the twelve conv1 calls of the non-first blocks read 4x their width
    wide = [k for k in CONV_CALLS if k[2] == 4 * k[3]]
    assert len(wide) == 12


def _check_chunks(plan, rows):
    chunks, kc = plan["chunks"], plan["kc"]
    assert kc % fb.K_STEP == 0 and fb.K_STEP == 64
    assert (chunks - 1) * kc < rows <= chunks * kc


@pytest.mark.parametrize("key", CONV_CALLS)
def test_conv_plan_keeps_y_unless_recomputing_takes_less_time(key):
    """#8 in bf16 keeps the product y in f32 (one write and two reads, 12
    Cout bytes a row) unless recomputing it twice more from bf16 x takes
    less time (4 Cin bytes a row and two products of 2 Cin Cout
    operations, at 100 operations a byte): on this path it recomputes
    only at the two calls that read 64 channels (64 -> 64 and the
    projection 64 -> 256)."""
    b, hw, cin, cout, g, relu = key
    plan = fb.bwd_plan("conv", b, hw, cin, cout, g, torch.bfloat16)
    rows = 4 * cin + 4 * cin * cout / fb.PRODUCT_FLOPS_PER_BYTE
    assert plan["store"] == (rows >= 12 * cout) == (cin > 64)
    scratch = {e[0]: e[1:] for e in plan["scratch"] if e is not None}
    assert [e is None for e in plan["scratch"]] == [not plan["store"]] \
        + [False] * 5
    if plan["store"]:
        assert scratch["ws"] == ((b, hw, cout), torch.float32)
    assert plan["row_tiles"] == -(-hw // fb.ROW_TILE)
    grad_tiles = plan["tiles"] if plan["store"] else plan["row_tiles"]
    assert scratch["part"] == (
        (b * (plan["row_tiles"] + grad_tiles) * 2 * cout,), torch.float32)
    assert scratch["gstats"] == ((b, g, 4), torch.float32)
    _check_chunks(plan, b * hw)


@pytest.mark.parametrize("key", TAIL_CALLS)
def test_tail_plan_has_no_f32_workspace_of_the_output_width(key):
    """#10 in bf16 recomputes y3 = h @ w in each pass that needs it
    instead of writing it as an f32 [B*HW, Cout] workspace (16 Cout bytes
    a row against Cout / 2 to reread h), and keeps dh in f32 (4 Cm bytes
    a row against 2 Cout to recompute)."""
    b, hw, cm, cout, g2, g3 = key
    plan = fb.bwd_plan("tail", b, hw, cm, cout, (g2, g3), torch.bfloat16)
    f32 = [e for e in plan["scratch"]
           if e is not None and e[2] == torch.float32]
    assert all(int(np.prod(e[1])) < b * hw * cout for e in f32)
    assert ("ws2", (b, hw, cm), torch.float32) in plan["scratch"]
    assert plan["scratch"][1] is None          # the C order's ws3 slot
    # the f32 chain keeps its workspace
    f32_plan = fb.bwd_plan("tail", b, hw, cm, cout, (g2, g3), torch.float32)
    assert ("ws3", (b, hw, cout), torch.float32) in f32_plan["scratch"]
    _check_chunks(plan, b * hw)


def test_plan_rejects_an_unknown_kind():
    with pytest.raises(ValueError, match="kind"):
        fb.bwd_plan("head", 2, 4, 8, 8, 4, torch.bfloat16)


def test_cuda_width_check_names_the_16_byte_rows():
    """A width off the 16-byte vectors of TMA and of the passes' loads is
    refused before any launch, in both dtypes (the f32 kernels' norm
    passes load 16 bytes too); the check reads the tensor, so a CPU
    tensor shows it too."""
    for odd in (torch.zeros(2, 4, 12, dtype=torch.bfloat16),
                torch.zeros(2, 4, 12)):
        with pytest.raises(ValueError, match="multiples of 8"):
            fb._check_kernel_inputs(odd)
    fb._check_kernel_inputs(torch.zeros(2, 4, 24, dtype=torch.bfloat16),
                            torch.zeros(2, 4, 16))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kind", ["conv", "tail"])
def test_forward_kernels_refuse_an_odd_width_before_any_launch(kind, dtype):
    """The forwards now run on TMA (bf16) and the 16-byte passes (both
    dtypes): a width of 12 raises in the wrapper, before the library is
    built or a launch queued."""
    x = torch.zeros(2, 4, 12, dtype=dtype)
    w = torch.zeros(12, 16, dtype=dtype)
    p16 = torch.zeros(16)
    p12 = torch.zeros(12)
    with pytest.raises(ValueError, match="multiples of 8"):
        if kind == "conv":
            fb._conv_gn_fwd_kernel(x, w, p16, p16, groups=4, eps=1e-6,
                                   relu=True)
        else:
            fb._tail_fwd_kernel(x, w, p12, p12, p16, p16,
                                torch.zeros(2, 4, 16, dtype=dtype),
                                groups2=4, groups3=4, eps=1e-6)


def _fwd_rows_over(cin, cout):
    """Bytes a row that a bf16 forward's plan moves beyond what both
    plans move: store writes and reads the f32 product; recompute reads
    the product's input again and runs the product once more."""
    return {"store": 8 * cout,
            "recompute": 2 * cin
            + 2 * cin * cout / fb.FWD_PRODUCT_FLOPS_PER_BYTE}


@pytest.mark.parametrize("kind,key", [("conv", k) for k in CONV_CALLS]
                         + [("tail", k) for k in TAIL_CALLS])
def test_forward_plan_keeps_y_unless_recomputing_takes_less_time(kind, key):
    """#7 and #9 in bf16 keep the product y in f32 between their two
    passes (8 Cout bytes a row more) unless one more read of its bf16
    input and one more product (2 Cin bytes and 2 Cin Cout operations a
    row, at 132 operations a byte) take less time.  The f32 scratch is
    ``ws`` exactly when y is kept; the product's statistics come per
    64-row tile (its epilogue), GN2's per R-row tile (a 16-byte pass)."""
    b, hw, cin, cout = key[:4]
    groups = key[4] if kind == "conv" else key[4:6]
    plan = fb.fwd_plan(kind, b, hw, cin, cout, groups, torch.bfloat16)
    over = _fwd_rows_over(cin, cout)
    assert plan["store"] == (over["recompute"] >= over["store"])
    assert plan["row_tiles"] == -(-hw // fb.ROW_TILE)
    assert plan["tiles"] == -(-hw // plan["rows"])
    scratch = {e[0]: e[1:] for e in plan["scratch"] if e is not None}
    assert ("ws" in scratch) == plan["store"]
    if plan["store"]:
        assert scratch["ws"] == ((b, hw, cout), torch.float32)
    if kind == "conv":
        assert len(plan["scratch"]) == 3
        assert scratch["part"] == ((b, plan["row_tiles"], 2, cout),
                                   torch.float32)
        assert scratch["gstats"] == ((b, groups, 4), torch.float32)
    else:
        assert len(plan["scratch"]) == 6
        assert scratch["hb"] == ((b, hw, cin), torch.bfloat16)
        assert scratch["part2"] == ((b, plan["tiles"], 2, cin),
                                    torch.float32)
        assert scratch["part3"] == ((b, plan["row_tiles"], 2, cout),
                                    torch.float32)
        assert scratch["gstats3"] == ((b, groups[1], 4), torch.float32)
    # f32 keeps the FMA product's workspace, its statistics per R-row tile
    f32 = fb.fwd_plan(kind, b, hw, cin, cout, groups, torch.float32)
    assert f32["store"] and ("ws", (b, hw, cout), torch.float32) \
        in f32["scratch"]


@pytest.mark.parametrize("store", [True, False])
@pytest.mark.parametrize("kind", ["conv", "tail"])
def test_forward_plan_can_be_forced_either_way(kind, store):
    """Both bf16 plans of either forward exist at any shape (the smoke
    times the one the rule does not choose); f32 always keeps y."""
    groups = 32 if kind == "conv" else (32, 32)
    plan = fb.fwd_plan(kind, 2, 49, 512, 2048, groups, torch.bfloat16,
                       store)
    assert plan["store"] is store
    ws = plan["scratch"][0 if kind == "conv" else 1]
    assert (ws is None) is not store
    assert fb.fwd_plan(kind, 2, 49, 512, 2048, groups, torch.float32,
                       store)["store"]


def test_forward_plan_rejects_an_unknown_kind():
    with pytest.raises(ValueError, match="kind"):
        fb.fwd_plan("head", 2, 4, 8, 8, 4, torch.bfloat16)


def test_forward_plan_at_the_path_is_the_timed_choice():
    """On ResNet-50's path the rule recomputes the conv's product where x
    has 64 channels and at the two stage-2 calls that read 256 (256 ->
    128 over 3136 rows, the 256 -> 512 projection), and the tail's where
    C_m is at most 256: the faster plan at each of the 36 calls as timed
    on an H100 (PERF.md, PR 9)."""
    conv = {k[2:4]: fb.fwd_plan("conv", *k[:5], torch.bfloat16)["store"]
            for k in CONV_CALLS}
    tail = {k[2:4]: fb.fwd_plan("tail", *k[:4], k[4:6],
                                torch.bfloat16)["store"] for k in TAIL_CALLS}
    assert {c for c, kept in conv.items() if not kept} == {
        (64, 64), (64, 256), (256, 128), (256, 512)}
    assert {c for c, kept in tail.items() if not kept} == {
        (64, 256), (128, 512), (256, 1024)}


@pytest.mark.parametrize("store", [True, False])
def test_conv_plan_can_be_forced_either_way(store):
    """Both bf16 plans of #8 exist at any shape (the smoke times the one
    the byte rule does not choose); f32 always keeps y; the tail has one
    plan."""
    key = (2, 49, 64, 256, 32)        # the rule recomputes here
    plan = fb.bwd_plan("conv", *key, torch.bfloat16, store)
    assert plan["store"] is store
    assert (plan["scratch"][0] is None) is not store
    assert fb.bwd_plan("conv", *key, torch.float32, store)["store"]
    with pytest.raises(ValueError, match="one plan"):
        fb.bwd_plan("tail", 2, 49, 64, 256, (32, 32), torch.bfloat16, store)


# ---- the fused block against the unfused one, inside the port ---------


@pytest.mark.parametrize("stride,cin", [(1, 32), (2, 16)])
def test_fused_block_matches_unfused_block(stride, cin):
    """Output and every parameter's gradient of the fused block against
    ``BottleneckBlock(norm="group")`` from parameters mapped as the JAX
    package's ``tests/test_fused_block.py`` maps them, perturbed first
    (gn3's scale starts at zero and would hide the whole tail)."""
    torch.manual_seed(0)
    ref = BottleneckBlock(cin, 8, stride, AdaptiveGroupNorm, torch.float32)
    fused = FusedBottleneckBlock(cin, 8, stride, torch.float32)
    rng = np.random.default_rng(13)
    sd = {k: torch.tensor(_rand(rng, v.shape, 0.3, 1.0 if k.endswith(
              "scale") else 0.0)) for k, v in ref.state_dict().items()}
    ref.load_state_dict(sd)
    fused.load_state_dict(_map_block_params(sd))
    x = _img(_rand(rng, (2, 8, 8, cin)))
    yu, yf = ref(x), fused(x)
    np.testing.assert_allclose(yf.detach().numpy(), yu.detach().numpy(),
                               rtol=1e-5, atol=2e-5)
    gu = torch.autograd.grad(torch.sin(yu).sum(), list(ref.parameters()))
    gf = torch.autograd.grad(torch.sin(yf).sum(), list(fused.parameters()))
    gu = _map_block_params(dict(zip(dict(ref.named_parameters()), gu)))
    for (name, _), g in zip(fused.named_parameters(), gf):
        np.testing.assert_allclose(g.numpy(), gu[name].numpy(), rtol=1e-4,
                                   atol=3e-5, err_msg=name)


# ---- whole models against the JAX package ------------------------------


MODELS = {"pallas_block": dict(fusion="pallas_block"),
          "pallas_tail": dict(fusion="pallas_tail"),
          "fusion_stages_0": dict(fusion="pallas_block", fusion_stages=(0,))}


def _resnet_kw(**kw):
    return dict(num_classes=5, stage_sizes=(1, 1), width=8,
                dtype="float32", **kw)


@functools.lru_cache(maxsize=None)
def _jax_grad_fn(case):
    model = ModelSpec.from_config(jax_config(
        "resnet", (16, 16, 3), **_resnet_kw(**MODELS[case]))).build()

    def loss(params, x, y):
        logits = model.apply({"params": params}, x)
        return -jnp.mean(jnp.take_along_axis(
            jax.nn.log_softmax(logits), y[:, None], axis=1)), logits

    return jax.jit(jax.value_and_grad(loss, has_aux=True))


@pytest.mark.parametrize("case", list(MODELS))
def test_fused_resnet_matches_jax(case):
    """Logits, loss and step 1's gradient of every parameter, from one
    draw of weights (norm scales around 1, so no block branch starts at
    zero) carried to the JAX model by ``convert.params_to_flax``."""
    kw = _resnet_kw(**MODELS[case])
    port = build_model(model_config("resnet", (16, 16, 3), **kw),
                       device="cpu")
    rng = np.random.default_rng(14)
    sd = {}
    for k, v in port.state_dict().items():
        noise = rng.standard_normal(v.shape).astype(np.float32)
        sd[k] = torch.from_numpy(noise * 0.3 + k.endswith("scale")
                                 if v.dim() == 1 else noise * v.std().item())
    port.load_state_dict(sd)
    x = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    y = np.array([1, 3])
    (want_loss, want_logits), want = _jax_grad_fn(case)(
        convert.params_to_flax(sd), x, y)
    params = {n: p.detach().clone().requires_grad_()
              for n, p in port.named_parameters()}
    logits = torch.func.functional_call(port, params, (torch.tensor(x),))
    loss = torch.nn.functional.cross_entropy(logits, torch.tensor(y))
    got = convert.params_to_flax(dict(zip(params, torch.autograd.grad(
        loss, list(params.values())))))
    want_logits = np.asarray(want_logits)
    rms = np.sqrt(np.mean(want_logits ** 2))
    assert np.abs(logits.detach().numpy() - want_logits).max() <= 1e-4 * rms
    assert abs(loss.item() - float(want_loss)) <= 1e-4 * abs(float(want_loss))
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    flat_w = dict(jax.tree_util.tree_flatten_with_path(
        jax.tree_util.tree_map(np.asarray, want))[0])
    assert flat_g.keys() == flat_w.keys()
    total = np.sqrt(sum(np.sum(w ** 2) for w in flat_w.values()))
    for path, w in flat_w.items():
        err = np.linalg.norm(flat_g[path] - w)
        assert err <= 1e-3 * max(np.linalg.norm(w), 1e-3 * total), (
            jax.tree_util.keystr(path), err, np.linalg.norm(w))


def test_strided_downsample_is_copied_once_per_forward():
    """The downsample reads ``x[:, :, ::2, ::2]``: one explicit
    channels-last copy per strided block per forward, none elsewhere."""
    port = build_model(model_config("resnet", (16, 16, 3), **_resnet_kw(
        fusion="pallas_block")), device="cpu")
    before = fb.input_copies
    port(torch.zeros(2, 16, 16, 3))
    assert fb.input_copies == before + 1
