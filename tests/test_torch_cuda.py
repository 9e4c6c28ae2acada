"""Tests of the port that need an NVIDIA GPU: the CUDA flash kernels
(forward and backward) and GroupNorm kernels (forward and backward)
against their plain versions, the serving path launching the forward
kernel, a training step through the three flash kernels, a ResNet's
gradients through the GroupNorm kernels against ``F.group_norm``,
ADAG's rounds launching them, the fused-block kernels against their
plain versions, their launches per step and a deterministic fused step,
the ring-hop kernels against their plain versions and a
sequence-parallel LM step through them, and bit-equal reruns of the bf16
forward and backward kernels (the fused forwards under both pass plans;
the GroupNorm kernels on the one-pass route, whose routes are held
against the plain versions at the PS path's shapes), the GroupNorm
kernels called from four host threads at once, the BiLSTM's cuDNN
recurrence against its plain time loop, and the native columnar
library's C lane on the card's machine.
They skip without a card (the kernels have no CPU mode).  The file imports
neither JAX nor the JAX package, so it runs on a machine without them:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from torch.func import functional_call

from distkeras_tpu_torch import DecodeEngine, build_model, generate
from distkeras_tpu_torch.models import model_config
from distkeras_tpu_torch.ops import attention
from distkeras_tpu_torch.ops.losses import categorical_crossentropy

pytestmark = pytest.mark.cuda

# bf16: one rounding of P and one of out; f32: summation order only
TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
# dq, dk, dv per element: |grad - plain| <= TOL_GRAD * (|plain| +
# rms(plain)).  bf16: each side rounds its f32 sum once (half an ulp,
# 2^-8 of |plain|), and a one-ulp flip of a rounded ds or p moves a sum
# of many terms by a small share of its typical size, rms(plain); 2^-6
# leaves twice that room.  f32: summation order and expf against
# torch.exp
TOL_GRAD = {torch.bfloat16: 2 ** -6, torch.float32: 1e-5}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


# 200 rows: one ragged tile past three full ones; 520 rows, causal: a
# ragged tile past eight, so the walk to the diagonal crosses tiles the
# mask leaves whole before it meets the ragged edge
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal,t", [(True, 200), (False, 200),
                                      (True, 520)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_matches_plain(card, dtype, causal, t, d):
    gen = torch.Generator(device="cuda").manual_seed(d)
    q, k, v = (torch.randn(2, 4, t, d, device="cuda", dtype=dtype,
                           generator=gen) for _ in range(3))
    before = attention.launches
    out, lse = attention.flash_attention_bhtd(q, k, v, scale=d ** -0.5,
                                              causal=causal)
    ref, ref_lse = attention.flash_attention_reference(
        q, k, v, scale=d ** -0.5, causal=causal)
    assert attention.launches == before + 1
    assert out.dtype == dtype and lse.dtype == torch.float32
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]
    assert (lse - ref_lse).abs().max().item() <= 1e-4


def test_kernel_rejects_a_head_size_it_was_not_built_for(card):
    q = torch.zeros(1, 1, 64, 32, device="cuda")
    with pytest.raises(ValueError, match="head sizes"):
        attention.flash_attention_bhtd(q, q, q, scale=1.0)


def test_engine_launches_the_kernel_and_matches_generate(card):
    cfg = model_config("transformer_lm", (512,), input_dtype="int32",
                       vocab_size=256, num_layers=2, d_model=128,
                       num_heads=2, num_kv_heads=1, max_len=512,
                       dtype="bfloat16", flash_attn=True)
    torch.manual_seed(0)
    model = build_model(cfg).eval()
    rng = np.random.default_rng(0)
    reqs = [{"prompt": rng.integers(0, 256, (t,)), "max_new_tokens": n}
            for t, n in ((30, 8), (200, 12), (129, 5))]
    attention.launches = 0
    res = list(DecodeEngine(model, slots=2, buckets=[256, 512]).run(reqs))
    assert attention.launches == 2 * len(reqs)
    for req, r in zip(reqs, res):
        p = req["prompt"]
        want = generate(model, p[None], max_new_tokens=req["max_new_tokens"])
        np.testing.assert_array_equal(r["tokens"],
                                      want[0, len(p):].cpu().numpy())


def _counts():
    return (attention.launches, attention.bwd_dq_launches,
            attention.bwd_dkv_launches)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_backward_kernels_match_plain(card, dtype, causal, d):
    gen = torch.Generator(device="cuda").manual_seed(d + 1)
    q, k, v, dout = (torch.randn(2, 4, 200, d, device="cuda", dtype=dtype,
                                 generator=gen) for _ in range(4))
    scale = d ** -0.5
    out, lse = attention.flash_attention_reference(q, k, v, scale=scale,
                                                   causal=causal)
    before = _counts()
    got = attention.flash_attention_bwd_bhtd(q, k, v, out, lse, dout,
                                             scale=scale, causal=causal)
    want = attention.flash_attention_bwd_reference(
        q, k, v, out, lse, dout, scale=scale, causal=causal)
    torch.cuda.synchronize()
    assert _counts() == (before[0], before[1] + 1, before[2] + 1)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and a.shape == q.shape
        a, b = a.float(), b.float()
        rms = b.square().mean().sqrt()
        ratio = ((a - b).abs() / (b.abs() + rms)).max().item()
        assert ratio <= TOL_GRAD[dtype], (name, ratio, rms.item())


def _grads(model, x, y):
    """f32 master parameters cast to the module's dtypes, as the
    training step casts them; returns their gradients by name."""
    own = dict(model.named_parameters())
    params = {n: p.detach().float().requires_grad_() for n, p in own.items()}
    logits = functional_call(model, {n: p.to(own[n].dtype)
                                     for n, p in params.items()}, (x,))
    loss = categorical_crossentropy(logits, y)
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True)
    return dict(zip(params, grads))


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-3),
                                       ("bfloat16", 5e-2)])
def test_train_step_gives_every_parameter_its_gradient(card, dtype, tol):
    """A flash step on the card: every parameter, query/key/value
    included, gets a gradient, each within ``tol`` (relative norm) of
    the dense step's on the same weights, with one launch of each kernel
    per layer.  bf16 allows 5e-2: the dense path rounds its logits to
    bf16, the kernels keep them in f32.  The key biases get no gradient
    in exact arithmetic (softmax ignores a shift common to all keys), so
    theirs is rounding noise: it must stay below 1e-3 of the whole
    gradient's norm in both steps."""
    cfg = dict(vocab_size=256, num_layers=2, d_model=128, num_heads=2,
               num_kv_heads=1, max_len=128, dtype=dtype)
    torch.manual_seed(0)
    flash = build_model(model_config("transformer_lm", (128,),
                                     input_dtype="int32", flash_attn=True,
                                     **cfg))
    dense = build_model(model_config("transformer_lm", (128,),
                                     input_dtype="int32", attn="dense",
                                     **cfg))
    dense.load_state_dict(flash.state_dict())
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(0, 256, (4, 128))).cuda()
    y = torch.from_numpy(rng.integers(0, 256, (4, 128))).cuda()
    before = _counts()
    got = _grads(flash, x, y)
    torch.cuda.synchronize()
    assert _counts() == tuple(c + 2 for c in before)
    want = _grads(dense, x, y)
    total = torch.stack([g.norm() for g in want.values()]).norm()
    for name, g in got.items():
        assert g is not None, name
        if name.endswith("attn.key.bias"):
            for x in (g, want[name]):
                assert x.norm().item() <= 1e-3 * total.item(), name
            continue
        scale = max(want[name].norm().item(), 1e-3 * total.item())
        assert (g - want[name]).norm().item() <= tol * scale, name


# GroupNorm kernels against their plain versions, per element scaled by
# |plain| + rms(plain): f32 differs by summation order (mean and inv-std
# to ~1e-6) carried through; bf16 may round one element either side of
# a rounding boundary: one bf16 ulp of |y|
GN_TOL = {torch.float32: 1e-4, torch.bfloat16: 2 ** -7}
# [B, HW, C, G]: the ResNet-50 stem's narrow groups, a wide late stage,
# an odd row count and channels off the 16-byte vector (scalar path)
GN_SHAPES = [(4, 12544, 64, 32), (3, 49, 2048, 32), (2, 37, 96, 8),
             (2, 25, 12, 4)]


def _ratio(a, b):
    a, b = a.float(), b.float()
    rms = b.square().mean().sqrt()
    return ((a - b).abs() / (b.abs() + rms)).max().item()


def _gn_inputs(shape, dtype, seed):
    from distkeras_tpu_torch.ops import group_norm as gn

    b, hw, c, g = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn(b, hw, c, device="cuda", generator=gen) * 2 + 0.5
         ).to(dtype)
    dy = torch.randn(b, hw, c, device="cuda", generator=gen).to(dtype)
    gamma = torch.randn(c, device="cuda", generator=gen) * 0.5 + 1
    beta = torch.randn(c, device="cuda", generator=gen) * 0.1
    return gn, x, dy, gamma, beta, g


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", GN_SHAPES)
def test_group_norm_kernels_match_plain(card, shape, dtype, relu):
    gn, x, dy, gamma, beta, g = _gn_inputs(shape, dtype, sum(shape))
    before = (gn.fwd_launches, gn.bwd_launches)
    y, mean, inv = gn.group_norm_fwd(x, gamma, beta, groups=g, relu=relu)
    ry, rmean, rinv = gn.group_norm_fwd_reference(x, gamma, beta, groups=g,
                                                  relu=relu)
    # the backward of both from the same statistics, so both recompute
    # the same x-hat and take the same ReLU mask
    dx, dg, db = gn.group_norm_bwd(x, dy, gamma, beta, rmean, rinv,
                                   groups=g, relu=relu)
    rdx, rdg, rdb = gn.group_norm_bwd_reference(x, dy, gamma, beta, rmean,
                                                rinv, groups=g, relu=relu)
    torch.cuda.synchronize()
    assert (gn.fwd_launches, gn.bwd_launches) == (before[0] + 1,
                                                  before[1] + 1)
    assert y.dtype == dx.dtype == dtype and y.shape == dx.shape == x.shape
    assert _ratio(y, ry) <= GN_TOL[dtype]
    assert _ratio(dx, rdx) <= GN_TOL[dtype]
    # f32 statistics and parameter gradients: summation order only
    assert (mean - rmean).abs().max().item() <= 1e-5
    assert ((inv - rinv).abs() / rinv).max().item() <= 1e-5
    assert _ratio(dg, rdg) <= 1e-4 and _ratio(db, rdb) <= 1e-4


# the PS path's GroupNorm shapes: ResNet-50 at 224 px, batch 32, 32
# groups ([HW, C] of its 53 GroupNorms a step)
GN_PATH_SHAPES = [(32, hw, c, 32) for hw, c in (
    (12544, 64), (3136, 64), (3136, 128), (3136, 256), (784, 128),
    (784, 256), (784, 512), (196, 256), (196, 512), (196, 1024), (49, 512),
    (49, 2048))]


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", GN_SHAPES + GN_PATH_SHAPES)
def test_group_norm_routes_match_plain(card, shape, dtype, relu):
    """The route ``gn_plan`` chooses and, where that is the one-pass
    route, the two-pass route too, against the plain versions at the
    limits above; each call counted under its route."""
    gn, x, dy, gamma, beta, g = _gn_inputs(shape, dtype, sum(shape) + 1)
    ry, rmean, rinv = gn.group_norm_fwd_reference(x, gamma, beta, groups=g,
                                                  relu=relu)
    rdx, rdg, rdb = gn.group_norm_bwd_reference(x, dy, gamma, beta, rmean,
                                                rinv, groups=g, relu=relu)
    chosen = {d: gn.launch_plan(*shape, dtype, d, "cuda").route
              for d in ("fwd", "bwd")}
    routes = [None] + (["two_pass"] if "one_pass" in chosen.values()
                       else [])
    for route in routes:
        before = dict(gn.route_launches)
        y, mean, inv = gn._fwd_kernel(x, gamma, beta, groups=g, eps=1e-6,
                                      relu=relu, route=route)
        dx, dg, db = gn._bwd_kernel(x, dy, gamma, beta, rmean, rinv,
                                    groups=g, relu=relu, route=route)
        torch.cuda.synchronize()
        for d in ("fwd", "bwd"):
            key = f"{d}_{route or chosen[d]}"
            assert gn.route_launches[key] == before[key] + 1, key
        assert _ratio(y, ry) <= GN_TOL[dtype]
        assert _ratio(dx, rdx) <= GN_TOL[dtype]
        assert (mean - rmean).abs().max().item() <= 1e-5
        assert ((inv - rinv).abs() / rinv).max().item() <= 1e-5
        assert _ratio(dg, rdg) <= 1e-4 and _ratio(db, rdb) <= 1e-4


@pytest.mark.parametrize("splits,k", [(1, 1), (2, 2), (4, 1), (8, 4),
                                      (2, 8)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_group_norm_channel_splits_match_plain(card, dtype, splits, k):
    """The one-pass kernels with each image cut into channel splits (each
    its own cluster) against the plain versions, off every edge: 37 rows
    over k blocks, ReLU on."""
    shape = (3, 37, 512, 32)
    gn, x, dy, gamma, beta, g = _gn_inputs(shape, dtype, splits * 10 + k)
    kw = dict(groups=g, relu=True)
    ry, rmean, rinv = gn.group_norm_fwd_reference(x, gamma, beta, **kw)
    rdx, rdg, rdb = gn.group_norm_bwd_reference(x, dy, gamma, beta, rmean,
                                                rinv, **kw)
    y, mean, inv = gn._fwd_kernel(x, gamma, beta, eps=1e-6, k=k,
                                  splits=splits, **kw)
    dx, dg, db = gn._bwd_kernel(x, dy, gamma, beta, rmean, rinv, k=k,
                                splits=splits, **kw)
    torch.cuda.synchronize()
    assert _ratio(y, ry) <= GN_TOL[dtype]
    assert _ratio(dx, rdx) <= GN_TOL[dtype]
    assert (mean - rmean).abs().max().item() <= 1e-5
    assert ((inv - rinv).abs() / rinv).max().item() <= 1e-5
    assert _ratio(dg, rdg) <= 1e-4 and _ratio(db, rdb) <= 1e-4


@pytest.mark.parametrize("shape", GN_PATH_SHAPES)
def test_bf16_group_norm_one_pass_reruns_are_bit_equal(card, shape):
    """Every bf16 GroupNorm of the PS path takes the one-pass route, and
    two runs give bit-equal outputs (fixed-order folds, no atomics)."""
    gn, x, dy, gamma, beta, g = _gn_inputs(shape, torch.bfloat16, 3)
    for d in ("fwd", "bwd"):
        assert gn.launch_plan(*shape, torch.bfloat16, d, "cuda").route \
            == "one_pass"

    def run():
        y, mean, inv = gn.group_norm_fwd(x, gamma, beta, groups=g, relu=True)
        return (y, mean, inv, *gn.group_norm_bwd(x, dy, gamma, beta, mean,
                                                 inv, groups=g, relu=True))

    first, again = run(), run()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_group_norm_one_pass_plans_fit_the_card(card, direction):
    """At the PS path's shapes the launch takes the shared memory
    ``gn_plan`` counted, and the card holds at least one such cluster
    at once (``cudaOccupancyMaxActiveClusters``)."""
    from distkeras_tpu_torch.ops import group_norm as gn

    for shape in GN_PATH_SHAPES:
        plan = gn.launch_plan(*shape, torch.bfloat16, direction, "cuda")
        smem, clusters = gn.one_pass_launch(plan, *shape, torch.bfloat16,
                                            direction)
        assert smem == plan.smem <= gn.SMEM_PER_BLOCK, shape
        assert clusters >= 1, shape


def test_group_norm_kernels_from_four_threads(card):
    """Four host threads make the first calls at once (the library and
    the plans dropped first, so the threads race to load and plan them),
    then run both kernels at the PS path's shapes: the library loads
    once, every launch is counted, and every result matches the plain
    version on the same inputs."""
    import threading

    from distkeras_tpu_torch.ops import _build

    gn = _gn_inputs(GN_PATH_SHAPES[0], torch.bfloat16, 0)[0]
    gn._library.cache_clear()
    gn._launch_plan.cache_clear()
    _build._loaded.pop("group_norm", None)
    shapes = GN_PATH_SHAPES[::3]
    cases = [_gn_inputs(shape, torch.bfloat16, i)
             for i, shape in enumerate(shapes)]
    want = []
    for _, x, dy, gamma, beta, g in cases:
        ry, rmean, rinv = gn.group_norm_fwd_reference(x, gamma, beta,
                                                      groups=g, relu=True)
        want.append((ry, gn.group_norm_bwd_reference(
            x, dy, gamma, beta, rmean, rinv, groups=g, relu=True)[0],
            rmean, rinv))
    before = (gn.fwd_launches, gn.bwd_launches)
    libs, errors, reps = [], [], 3

    def work(t):
        try:
            libs.append(gn._library())
            for _ in range(reps):
                for (_, x, dy, gamma, beta, g), (ry, rdx, rmean, rinv) in \
                        zip(cases, want):
                    y, _, _ = gn.group_norm_fwd(x, gamma, beta, groups=g,
                                                relu=True)
                    dx, _, _ = gn.group_norm_bwd(x, dy, gamma, beta, rmean,
                                                 rinv, groups=g, relu=True)
                    torch.cuda.current_stream().synchronize()
                    assert _ratio(y, ry) <= GN_TOL[torch.bfloat16]
                    assert _ratio(dx, rdx) <= GN_TOL[torch.bfloat16]
        except BaseException as e:  # handed to the test thread
            errors.append(e)

    threads = [threading.Thread(target=work, args=(t,)) for t in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
        assert not t.is_alive()
    if errors:
        raise errors[0]
    assert len({id(lib) for lib in libs}) == 1
    assert libs[0] is _build._loaded["group_norm"]
    n = 4 * reps * len(cases)
    assert (gn.fwd_launches, gn.bwd_launches) == (before[0] + n,
                                                  before[1] + n)


def test_group_norm_kernel_takes_channels_last_only(card):
    from distkeras_tpu_torch.ops import group_norm as gn

    x = torch.randn(2, 64, 8, 8, device="cuda")
    w, b = torch.ones(64, device="cuda"), torch.zeros(64, device="cuda")
    with pytest.raises(ValueError, match="channels-last"):
        gn.group_norm(x, w, b, groups=32)
    y = gn.group_norm(x.contiguous(memory_format=torch.channels_last), w, b,
                      groups=32)
    assert y.is_contiguous(memory_format=torch.channels_last)


def _resnet_cfg(norm, **kw):
    return model_config("resnet", (32, 32, 3), num_classes=5,
                        stage_sizes=(1, 1), width=16, norm=norm,
                        stem="space_to_depth", **kw)


def test_resnet_gradients_group_pallas_match_group(card):
    """One step's gradient of every parameter of a small ResNet through
    the GroupNorm kernels against ``F.group_norm``, in f32 from the same
    weights (norm parameters drawn around their init, so every branch is
    live): within 1e-3 of each parameter's norm (floor 1e-3 of the whole
    gradient's), summation order only; one launch of each kernel per
    GroupNorm."""
    import re

    from distkeras_tpu_torch.ops import group_norm as gn

    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(0)
    pallas = build_model(_resnet_cfg("group_pallas", dtype="float32"))
    group = build_model(_resnet_cfg("group", dtype="float32"))
    gen = torch.Generator().manual_seed(1)
    sd = {k: (torch.randn(v.shape, generator=gen).to(v.device) * 0.1
              + (k.endswith("scale") and v.abs().sum() > 0))
          if k.endswith(("scale", "bias")) and "Dense" not in k else v
          for k, v in pallas.state_dict().items()}
    pallas.load_state_dict(sd)
    group.load_state_dict({re.sub(r"(AdaptiveGroupNorm_\d+)\.",
                                  r"\1.GroupNorm_0.", k): v
                           for k, v in sd.items()})
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((4, 32, 32, 3)).astype(
        np.float32)).cuda()
    y = torch.from_numpy(rng.integers(0, 5, 4)).cuda()
    n_norms = sum(1 for m in pallas.modules()
                  if type(m).__name__ == "AdaptiveGroupNorm")
    before = (gn.fwd_launches, gn.bwd_launches)
    got = _grads(pallas, x, y)
    torch.cuda.synchronize()
    assert (gn.fwd_launches, gn.bwd_launches) == (before[0] + n_norms,
                                                  before[1] + n_norms)
    want = list(_grads(group, x, y).values())
    total = torch.stack([g.norm() for g in want]).norm().item()
    for (name, g), w in zip(got.items(), want):
        scale = max(w.norm().item(), 1e-3 * total)
        assert (g - w).norm().item() <= 1e-3 * scale, name


def test_adag_round_launches_both_kernels_per_group_norm(card):
    """ADAG on the card through the faithful round: each kernel launches
    once per GroupNorm per step, on every worker, every round."""
    from distkeras_tpu_torch import ADAG
    from distkeras_tpu_torch.data import datasets
    from distkeras_tpu_torch.ops import group_norm as gn

    t = ADAG(_resnet_cfg("group_pallas"), num_workers=2,
             communication_window=2, batch_size=4, num_epoch=1,
             learning_rate=0.01, worker_optimizer="momentum",
             loss="sparse_categorical_crossentropy")
    n_norms = sum(1 for m in t.model.modules()
                  if type(m).__name__ == "AdaptiveGroupNorm")
    gn.fwd_launches = gn.bwd_launches = 0
    t.train(datasets.synthetic_classification(32, (32, 32, 3), 5))
    torch.cuda.synchronize()
    rounds = len(t.history["round_loss"])
    assert rounds == 2 and np.isfinite(t.history["round_loss"]).all()
    assert gn.fwd_launches == gn.bwd_launches == n_norms * 2 * 2 * rounds
    assert t.parameter_server_state.clock == 2 * rounds


# the fused-block kernels at three ResNet-50 path shapes each (batch 4)
# and one off every tile edge; inputs and tolerances as chip_smoke.py's
# phase 6 draws and states them
FB_CONV_KEYS = [(4, 3136, 64, 64, 32, True), (4, 784, 256, 512, 32, False),
                (4, 49, 2048, 512, 32, True), (2, 37, 40, 24, 8, True)]
FB_TAIL_KEYS = [(4, 3136, 64, 256, 32, 32), (4, 196, 256, 1024, 32, 32),
                (4, 49, 512, 2048, 32, 32), (2, 37, 24, 40, 8, 8)]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("kind,key", [("conv", k) for k in FB_CONV_KEYS]
                         + [("tail", k) for k in FB_TAIL_KEYS])
def test_fused_block_kernels_match_plain(card, kind, key, dtype):
    _fused_block_kernels_match_plain(kind, key, dtype)


# an odd count of 64-row tiles over the images: the bf16 products' last
# block pairs a tile with none (its second warpgroup reads zeros and
# writes nothing)
@pytest.mark.parametrize("kind,key", [("conv", (3, 37, 40, 24, 8, True)),
                                      ("conv", (3, 37, 104, 24, 8, True)),
                                      ("tail", (3, 37, 24, 40, 8, 8))])
def test_fused_block_kernels_match_plain_at_an_odd_tile_count(card, kind,
                                                              key):
    _fused_block_kernels_match_plain(kind, key, "bfloat16")


def _fused_block_kernels_match_plain(kind, key, dtype):
    import chip_smoke as cs
    from distkeras_tpu_torch.ops import fused_block as fb

    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(sum(key))
    before = cs._fb_counts(fb)
    if kind == "conv":
        args = cs._conv_gn_case(fb, torch, gen, key, getattr(torch, dtype))
        kw = dict(groups=key[4], relu=key[5])
        got = (fb.conv1x1_gn_fwd(*args[:4], **kw),
               *fb.conv1x1_gn_bwd(*args, **kw))
        want = (fb.conv1x1_gn_fwd_reference(*args[:4], **kw),
                *fb.conv1x1_gn_bwd_reference(*args, **kw))
        names = ("y", "dx", "dw", "dgamma", "dbeta")
        launched = ("conv1x1_gn_fwd", "conv1x1_gn_bwd")
    else:
        args = cs._tail_case(fb, torch, gen, key, getattr(torch, dtype))
        kw = dict(groups2=key[4], groups3=key[5])
        got = (fb.bottleneck_tail_fwd(*args[:7], **kw),
               *fb.bottleneck_tail_bwd(*args, **kw))
        want = (fb.bottleneck_tail_fwd_reference(*args[:7], **kw),
                *fb.bottleneck_tail_bwd_reference(*args, **kw))
        names = ("out", "dy2", "dw", "dg2", "db2", "dg3", "db3", "dres")
        launched = ("bottleneck_tail_fwd", "bottleneck_tail_bwd")
    torch.cuda.synchronize()
    after = cs._fb_counts(fb)
    assert {k: after[k] - before[k] for k in after} == {
        k: int(k in launched) for k in after}
    assert got[0].dtype == getattr(torch, dtype)
    for name, a, w in zip(names, got, want):
        assert a.shape == w.shape and a.dtype == w.dtype, name
        assert bool(torch.isfinite(a).all()), name
        assert _ratio(a, w) <= cs._fb_tol(name, dtype), (name, _ratio(a, w))


# bf16 #8 and #10 at the path's widths (batch 2), each plan of #8 (y kept
# in f32: Cin > 3 Cout; y recomputed), and the odd widths off every tile
# edge; inputs as chip_smoke.py's phase 6 draws them
FB_RERUN_KEYS = [("conv", (2, 3136, 256, 64, 32, True)),
                 ("conv", (2, 784, 256, 512, 32, False)),
                 ("conv", (2, 37, 104, 24, 8, True)),
                 ("conv", (2, 37, 40, 24, 8, True)),
                 ("tail", (2, 3136, 64, 256, 32, 32)),
                 ("tail", (2, 49, 512, 2048, 32, 32)),
                 ("tail", (2, 37, 24, 40, 8, 8))]


@pytest.mark.parametrize("kind,key", FB_RERUN_KEYS)
def test_bf16_fused_backward_kernels_rerun_bit_equal(card, kind, key):
    """Two runs of the bf16 #8 or #10 on the same inputs give the same
    bits: every sum (the products' depth, the statistics' rows and tiles,
    the weight gradient's chunks) is taken in a fixed order, without
    atomics, whichever pass plan the call takes."""
    import chip_smoke as cs
    from distkeras_tpu_torch.ops import fused_block as fb

    gen = torch.Generator(device="cuda").manual_seed(sum(key) + 3)
    if kind == "conv":
        args = cs._conv_gn_case(fb, torch, gen, key, torch.bfloat16)
        kw, fn = dict(groups=key[4], relu=key[5]), fb.conv1x1_gn_bwd
    else:
        args = cs._tail_case(fb, torch, gen, key, torch.bfloat16)
        kw, fn = dict(groups2=key[4], groups3=key[5]), fb.bottleneck_tail_bwd
    first, second = fn(*args, **kw), fn(*args, **kw)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert bool(torch.isfinite(a).all())
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind,key", FB_RERUN_KEYS)
def test_bf16_fused_forward_plans_and_reruns_are_bit_equal(card, kind, key):
    """The bf16 #7 or #9 gives the same bits when run twice under either
    pass plan, and the two plans give the same bits: the recompute plan's
    P2 computes P1's product exactly (same body, same depth order), and
    every fold runs in a fixed order."""
    import chip_smoke as cs
    from distkeras_tpu_torch.ops import fused_block as fb

    gen = torch.Generator(device="cuda").manual_seed(sum(key) + 5)
    if kind == "conv":
        args = cs._conv_gn_case(fb, torch, gen, key, torch.bfloat16)[:4]
        kw = dict(groups=key[4], eps=cs.FB_EPS, relu=key[5])
        fn = fb._conv_gn_fwd_kernel
    else:
        args = cs._tail_case(fb, torch, gen, key, torch.bfloat16)[:7]
        kw = dict(groups2=key[4], groups3=key[5], eps=cs.FB_EPS)
        fn = fb._tail_fwd_kernel
    outs = [fn(*args, **kw, store=store) for store in (True, True, False,
                                                        False)]
    torch.cuda.synchronize()
    assert bool(torch.isfinite(outs[0]).all())
    for o in outs[1:]:
        assert torch.equal(outs[0], o)


def _fused_cfg(**kw):
    return _resnet_cfg("group", **{"fusion": "pallas_block", **kw})


def test_fused_resnet_step_launches_each_kernel_per_block(card):
    """One training step of a small fused ResNet: each fused conv (one
    per block, one per projection) and each tail launches its forward and
    backward kernel once."""
    import chip_smoke as cs
    from distkeras_tpu_torch.ops import fused_block as fb
    from distkeras_tpu_torch.workers import (TrainState, make_train_step,
                                             resolve_optimizer)

    for kw, want in ((dict(), (4, 4, 2, 2)),
                     (dict(fusion="pallas_tail"), (0, 0, 2, 2)),
                     (dict(fusion_stages=(1,)), (2, 2, 1, 1))):
        model = build_model(_fused_cfg(**kw))
        tx = resolve_optimizer("momentum", 0.01)
        state = TrainState.create(model, model.state_dict(), tx)
        step = make_train_step(model, "sparse_categorical_crossentropy", tx)
        rng = np.random.default_rng(0)
        batch = {"features": torch.from_numpy(rng.standard_normal(
                     (4, 32, 32, 3)).astype(np.float32)).cuda(),
                 "label": torch.from_numpy(rng.integers(0, 5, 4)).cuda()}
        before = cs._fb_counts(fb)
        _, metrics = step(state, batch)
        torch.cuda.synchronize()
        after = cs._fb_counts(fb)
        assert tuple(after[k] - before[k] for k in cs.FB_KERNELS) == want, kw
        assert np.isfinite(float(metrics["loss"]))


def test_fused_training_is_deterministic(card):
    """Two runs of the same two steps from one start give bit-equal
    losses: no atomics, partials folded in a fixed order."""
    from distkeras_tpu_torch.workers import (TrainState, make_train_step,
                                             resolve_optimizer)

    model = build_model(_fused_cfg())
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}
    tx = resolve_optimizer("momentum", 0.1)
    step = make_train_step(model, "sparse_categorical_crossentropy", tx)
    rng = np.random.default_rng(1)
    batch = {"features": torch.from_numpy(rng.standard_normal(
                 (8, 32, 32, 3)).astype(np.float32)).cuda(),
             "label": torch.from_numpy(rng.integers(0, 5, 8)).cuda()}
    runs = []
    for _ in range(2):
        state = TrainState.create(model, start, tx)
        runs.append([float(step(state, batch)[1]["loss"]) for _ in range(2)])
    assert runs[0] == runs[1]


# each bf16 backward kernel once: inputs -> its outputs; the hop kernels
# at offsets that leave the block's diagonal off the 64-row tiles
BF16_BWD_CALLS = {
    "dq": lambda a, kw: (attention.flash_attention_bwd_dq(*a, **kw),),
    "dkv": lambda a, kw: attention.flash_attention_bwd_dkv(*a, **kw),
    "hop_dq": lambda a, kw: (attention.flash_hop_bwd_dq(
        *a, q_offset=300, k_offset=200, **kw),),
    "hop_dkv": lambda a, kw: attention.flash_hop_bwd_dkv(
        *a, q_offset=300, k_offset=200, **kw)}


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("kernel", sorted(BF16_BWD_CALLS))
def test_bf16_backward_kernels_rerun_bit_equal(card, kernel, d):
    """Two runs of a bf16 backward kernel on the same inputs give the same
    bits: every output element has one owner, so no atomics reorder its
    sum.  520 rows: several tiles of 64 and a ragged last one."""
    gen = torch.Generator(device="cuda").manual_seed(d + 11)
    q, k, v, do = (torch.randn(2, 4, 520, d, device="cuda",
                               dtype=torch.bfloat16, generator=gen)
                   for _ in range(4))
    lse = torch.randn(2, 4, 520, device="cuda", generator=gen) + 2
    dsum = torch.randn(2, 4, 520, device="cuda", generator=gen)
    args, kw = (q, k, v, do, lse, dsum), dict(scale=d ** -0.5, causal=True)
    first = BF16_BWD_CALLS[kernel](args, kw)
    second = BF16_BWD_CALLS[kernel](args, kw)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert bool(torch.isfinite(a).all())
        assert torch.equal(a, b)


# each bf16 forward kernel once: inputs -> its outputs; the hop kernel from
# a carried state (cloned: it updates the state in place) at offsets that
# leave the block's diagonal off the 64-row tiles
BF16_FWD_CALLS = {
    "fwd_causal": lambda q, k, v, st, s: attention.flash_attention_bhtd(
        q, k, v, scale=s, causal=True),
    "fwd": lambda q, k, v, st, s: attention.flash_attention_bhtd(
        q, k, v, scale=s, causal=False),
    "hop_fwd": lambda q, k, v, st, s: attention.flash_hop_fwd(
        q, k, v, *(x.clone() for x in st), q_offset=300, k_offset=200,
        scale=s, causal=True)}


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("kernel", sorted(BF16_FWD_CALLS))
def test_bf16_forward_kernels_rerun_bit_equal(card, kernel, d):
    """Two runs of a bf16 forward kernel on the same inputs give the same
    bits: each row's state has one owner.  520 rows: several tiles of 64
    and a ragged last one."""
    gen = torch.Generator(device="cuda").manual_seed(d + 13)
    q, k, v = (torch.randn(2, 4, 520, d, device="cuda",
                           dtype=torch.bfloat16, generator=gen)
               for _ in range(3))
    state = (torch.randn(2, 4, 520, device="cuda", generator=gen),
             torch.rand(2, 4, 520, device="cuda", generator=gen) + 0.5,
             torch.randn(2, 4, 520, d, device="cuda", generator=gen))
    first = BF16_FWD_CALLS[kernel](q, k, v, state, d ** -0.5)
    second = BF16_FWD_CALLS[kernel](q, k, v, state, d ** -0.5)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert bool(torch.isfinite(a).all())
        assert torch.equal(a, b)


# ---- the ring-hop kernels (#3-#4) and the sequence-parallel path ----

# (q_offset, k_offset, causal) of a 200-row q block against a 200-row k/v
# block, offsets as a ring of 200-row blocks gives them: the diagonal hop
# (first, from the initial state), a past block, a future block (dead),
# and a past block without the causal mask
HOP_CASES = {"diagonal": (200, 200, True), "past": (400, 0, True),
             "dead": (0, 200, True), "full": (0, 400, False)}


def _hop_counts():
    return (attention.hop_fwd_launches, attention.hop_dq_launches,
            attention.hop_dkv_launches)


def _hop_inputs(dtype, d, hop, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, device="cuda", generator=gen).to(dtype)

    q, k, v, do = (randn(2, 4, 200, d, dtype=dtype) for _ in range(4))
    if hop == "diagonal":
        m = torch.full((2, 4, 200), -1e30, device="cuda")
        l = torch.zeros(2, 4, 200, device="cuda")
        acc = torch.zeros(2, 4, 200, d, device="cuda")
    else:
        m, l, acc = randn(2, 4, 200), randn(2, 4, 200).abs() + 0.5, \
            randn(2, 4, 200, d)
    return q, k, v, do, m, l, acc, randn(2, 4, 200) + 2, randn(2, 4, 200)


@pytest.mark.parametrize("hop", sorted(HOP_CASES))
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_hop_kernels_match_plain(card, dtype, d, hop):
    """The three hop kernels against their plain versions: the state m
    to 1e-4 and l to 1e-4 of itself (f32 statistics), acc and the f32
    partials dq, dk, dv per element as the flash backward's; a dead hop
    passes the state and the carried sums bit for bit; a carried sum
    takes the partial added to it, exactly."""
    q, k, v, do, m, l, acc, lse, dsum = _hop_inputs(dtype, d, hop, d + 7)
    qo, ko, causal = HOP_CASES[hop]
    kw = dict(q_offset=qo, k_offset=ko, scale=d ** -0.5, causal=causal)
    before = _hop_counts()
    got = attention.flash_hop_fwd(q, k, v, m.clone(), l.clone(),
                                  acc.clone(), **kw)
    want = attention.flash_hop_fwd_reference(q, k, v, m, l, acc, **kw)
    grads = attention.flash_hop_bwd(q, k, v, do, lse, dsum, **kw)
    want_grads = (attention.flash_hop_bwd_dq_reference(
        q, k, v, do, lse, dsum, **kw),
        *attention.flash_hop_bwd_dkv_reference(q, k, v, do, lse, dsum, **kw))
    carried = [torch.randn_like(g) for g in grads]
    summed = attention.flash_hop_bwd(q, k, v, do, lse, dsum,
                                     dq=carried[0].clone(),
                                     dk=carried[1].clone(),
                                     dv=carried[2].clone(), **kw)
    torch.cuda.synchronize()
    # one forward launch, two of each backward kernel
    assert _hop_counts() == (before[0] + 1, before[1] + 2, before[2] + 2)
    if hop == "dead":
        for a, b in zip(got + grads, (m, l, acc) + want_grads):
            assert torch.equal(a, b)
    assert (got[0] - want[0]).abs().max().item() <= 1e-4
    assert ((got[1] - want[1]).abs() / want[1]).max().item() <= 1e-4
    for name, a, b in zip(("acc", "dq", "dk", "dv"), (got[2],) + grads,
                          (want[2],) + want_grads):
        assert a.dtype == torch.float32
        if b.abs().max() == 0:
            assert torch.equal(a, b), name
        else:
            assert _ratio(a, b) <= TOL_GRAD[dtype], (name, _ratio(a, b))
    for s, c, g in zip(summed, carried, grads):
        assert torch.equal(s, c + g)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-3),
                                       ("bfloat16", 5e-2)])
def test_ring_step_runs_the_hop_kernels(card, dtype, tol):
    """A step of a sequence-parallel LM over ``InProcessRing(4)`` with
    ``impl="flash"`` on the card: n^2 = 16 launches of each hop kernel
    per layer, none of the device-local flash kernels, and every
    parameter's gradient within ``tol`` (relative norm) of the
    ``flash_attn=True`` step on the same weights (the key biases, whose
    gradient is rounding noise, below 1e-3 of the whole)."""
    from distkeras_tpu_torch.parallel import ring_attention as ring

    cfg = dict(vocab_size=256, num_layers=2, d_model=128, num_heads=2,
               max_len=512, dtype=dtype)
    torch.manual_seed(0)
    seq = build_model(model_config(
        "transformer_lm", (512,), input_dtype="int32", seq_axis="seq",
        attn_fn=ring.ring_attn_fn("seq", impl="flash"), **cfg))
    flash = build_model(model_config("transformer_lm", (512,),
                                     input_dtype="int32", flash_attn=True,
                                     **cfg))
    flash.load_state_dict(seq.state_dict())
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.integers(0, 256, (2, 512))).cuda()
    y = torch.from_numpy(rng.integers(0, 256, (2, 512))).cuda()
    before, flash_before = _hop_counts(), _counts()
    got = ring.sequence_sharded_apply(
        lambda _: _grads(seq, x, y), ring.InProcessRing(4), "seq")(None)
    torch.cuda.synchronize()
    assert _hop_counts() == tuple(c + 16 * 2 for c in before)
    assert _counts() == flash_before
    want = _grads(flash, x, y)
    total = torch.stack([g.norm() for g in want.values()]).norm()
    for name, g in got.items():
        if name.endswith("attn.key.bias"):
            for a in (g, want[name]):
                assert a.norm().item() <= 1e-3 * total.item(), name
            continue
        scale = max(want[name].norm().item(), 1e-3 * total.item())
        assert (g - want[name]).norm().item() <= tol * scale, name


def test_bilstm_cudnn_recurrence_matches_the_loop(card):
    """The BiLSTM's fused route (torch's LSTM op, cuDNN on the card)
    against the plain time loop, f32 without TF32: logits and every
    gradient within 1e-4 of their rms, on rows with ragged lengths, an
    interior 0 and one all padding."""
    from distkeras_tpu_torch.models import lstm

    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(0)
    model = build_model(model_config("bilstm", (64,), input_dtype="int32",
                                     vocab_size=1000, embed_dim=32,
                                     hidden_dim=32))
    rng = np.random.default_rng(0)
    tok = rng.integers(1, 1000, size=(8, 64))
    tok[0, 40:] = 0
    tok[1, 10] = 0
    tok[2] = 0
    tok = torch.from_numpy(tok).cuda()
    params = dict(model.named_parameters())
    cot = torch.randn(8, 2, device="cuda")
    outs = {}
    for route in ("fused", "loop"):
        model.recurrence = route
        lstm.recurrence_calls[route] = 0
        out = model(tok)
        grads = torch.autograd.grad((out * cot).sum(), list(params.values()))
        outs[route] = [out] + list(grads)
        assert lstm.recurrence_calls[route] == 2
    for got, want in zip(outs["fused"], outs["loop"]):
        rms = want.float().pow(2).mean().sqrt().item()
        assert (got - want).abs().max().item() <= 1e-4 * rms + 1e-12


def test_native_lane_counters_beside_the_card(card, tmp_path):
    """The native columnar library builds on the card's machine and its
    C lane parses and buckets: every counter it should move moves."""
    from distkeras_tpu_torch import native
    from distkeras_tpu_torch.data import (Dataset, HashBucketTransformer,
                                          MinMaxTransformer)

    assert native.available(), native.why_unavailable()
    p = tmp_path / "c.csv"
    p.write_text("d,c,label\n" + "".join(
        f"{i * 0.5},cat_{i % 7},{i % 2}\n" for i in range(100)))
    native.reset_counts()
    ds = Dataset.from_csv(str(p))
    ds = HashBucketTransformer("c", 13).transform(
        MinMaxTransformer("d").fit_transform(ds))
    assert native.calls == {"fnv1a_bucket": 1, "affine_scale": 1,
                            "parse_csv": 1, "dense_scatter": 0}
    assert ds["c_bucket"].dtype == np.int32 and len(ds) == 100


def _serving_lm(**kw):
    cfg = model_config("transformer_lm", (512,), input_dtype="int32",
                       vocab_size=256, num_layers=2, d_model=128,
                       num_heads=2, num_kv_heads=1, max_len=512,
                       dtype="bfloat16", flash_attn=True, **kw)
    torch.manual_seed(0)
    return build_model(cfg).eval()


_SERVE_REQS = ((30, 8), (200, 12), (129, 5), (300, 6))


def _serving_reqs():
    rng = np.random.default_rng(0)
    return [{"prompt": rng.integers(0, 256, (t,)), "max_new_tokens": n}
            for t, n in _SERVE_REQS]


def test_int8_engine_launches_the_kernel_and_matches_generate(card):
    """The int8 KV engine on the card: tokens equal the int8 model's
    ``generate()`` per request, and the flash kernel runs once per layer
    per admission (the prefill on the raw projections)."""
    model = _serving_lm(kv_cache_dtype="int8")
    reqs = _serving_reqs()
    attention.launches = 0
    res = list(DecodeEngine(model, slots=2, buckets=[256, 512]).run(reqs))
    assert attention.launches == 2 * len(reqs)
    for req, r in zip(reqs, res):
        p = req["prompt"]
        want = generate(model, p[None], max_new_tokens=req["max_new_tokens"])
        np.testing.assert_array_equal(r["tokens"],
                                      want[0, len(p):].cpu().numpy())


def test_paged_engine_equals_the_envelope_engine(card):
    """Paged KV on the card: the gather runs the envelope body on the
    same rows, so the tokens equal the envelope engine's bit for bit,
    with the same launches per admission and every page back."""
    model = _serving_lm()
    reqs = _serving_reqs()
    kw = dict(slots=2, buckets=[256, 512], prefill_align=128)
    attention.launches = 0
    env = list(DecodeEngine(model, **kw).run(reqs))
    assert attention.launches == 2 * len(reqs)
    attention.launches = 0
    eng = DecodeEngine(model, kv_pages=12, page_size=128, **kw)
    paged = list(eng.run(reqs))
    assert attention.launches == 2 * len(reqs)
    for a, b in zip(env, paged):
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert eng.free_pages() == 12
