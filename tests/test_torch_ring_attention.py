"""Sequence parallelism of the port (``distkeras_tpu_torch.parallel.
ring_attention`` and the hop functions of ``ops.attention``) against the
JAX package on the CPU.

Inputs come from numpy seeds.  On the CPU the hop functions run their
plain versions, which take the TPU kernels' rounding points; the JAX hop
kernels run in Pallas interpret mode and the JAX ring under ``shard_map``
on 4 of the 8 virtual CPU devices.  The port's ring runs in both forms:
``InProcessRing(4)`` here, and a ``torch.distributed`` ring of 4 gloo
processes (``test_process_group_ring_matches_jax``), whose children
import only torch and the port.

Tolerances: f32 results agree up to summation order (the JAX tests' own
limits for the ring: out 2e-5, gradients 3e-5); bf16 hop results per
element within 2^-6 of (|jax| + rms(jax)), for a P or ds that one side
may round to the neighbouring bf16 value (the card's tolerance class).
"""

import functools
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from distkeras_tpu.models import ModelSpec
from distkeras_tpu.models import model_config as jax_model_config
from distkeras_tpu.ops import attention as jax_attention
from distkeras_tpu.ops.losses import resolve_loss as jax_resolve_loss
from distkeras_tpu.parallel.ring_attention import (
    blockwise_attention as jax_blockwise_attention,
    ring_attention as jax_ring_attention)
from distkeras_tpu.utils import shard_map
from distkeras_tpu_torch import build_model, convert, generate
from distkeras_tpu_torch.models import model_config
from distkeras_tpu_torch.models.transformer import dense_causal_attention
from distkeras_tpu_torch.ops import attention
from distkeras_tpu_torch.ops.losses import resolve_loss
from distkeras_tpu_torch.parallel import ring_attention as ring

jax.config.update("jax_platforms", "cpu")
# tiny shapes: one thread each keeps the parallel test workers off
# each other's cores
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
SEQ = "seq"
N = 4                       # ranks of the ring
B, T, H, D = 2, 32, 2, 8    # the JAX ring tests' shapes: T_local 8
TL = T // N
TOL_OUT, TOL_GRAD = 2e-5, 3e-5
TOL_HOP = {"float32": 1e-5, "bfloat16": 2 ** -6}
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
# ring offsets of a q block against a k/v block of T_local 8: the
# diagonal hop (first, from the initial state), a past block, a future
# block (dead: every key is later than every query), and a past block
# without the causal mask
HOPS = {"diagonal": (TL, TL, True), "past": (2 * TL, 0, True),
        "dead": (0, 2 * TL, True), "full": (0, 2 * TL, False)}
LM = dict(vocab_size=64, num_layers=2, d_model=32, num_heads=2, max_len=T,
          dtype="float32")


def _close(got, want, tol, name):
    """Per element ``|got - want| <= tol * (|want| + rms(want))``; all
    zeros (a dead hop's partials) exactly."""
    got, want = (np.asarray(x, np.float64) for x in (got, want))
    assert got.shape == want.shape, (name, got.shape, want.shape)
    rms = np.sqrt(np.mean(want ** 2))
    if rms == 0:
        np.testing.assert_array_equal(got, want, err_msg=name)
        return
    ratio = (np.abs(got - want) / (np.abs(want) + rms)).max()
    assert ratio <= tol, (name, ratio)


def _rounded(x, dname):
    """``x`` rounded to ``dname`` and widened to f32, so both packages
    start from the same values."""
    return torch.from_numpy(x).to(DTYPES[dname][0]).float().numpy()


def _hop_inputs(dname, hop, seed):
    rng = np.random.default_rng(seed)
    q, k, v, do = (_rounded(rng.standard_normal((B, H, TL, D),
                                                dtype=np.float32), dname)
                   for _ in range(4))
    if hop == "diagonal":   # the ring's first hop starts from the init
        m = np.full((B, H, TL), -1e30, np.float32)
        l = np.zeros((B, H, TL), np.float32)
        acc = np.zeros((B, H, TL, D), np.float32)
    else:                   # a state some earlier hops left
        m = rng.standard_normal((B, H, TL), dtype=np.float32)
        l = rng.uniform(0.5, 4.0, (B, H, TL)).astype(np.float32)
        acc = rng.standard_normal((B, H, TL, D), dtype=np.float32)
    lse = (rng.standard_normal((B, H, TL), dtype=np.float32) + 2.0)
    dsum = rng.standard_normal((B, H, TL), dtype=np.float32)
    return q, k, v, do, m, l, acc, lse, dsum


def _torch(x, dtype=torch.float32):
    return torch.tensor(np.asarray(x), dtype=dtype)


def _jax(x, dtype=jnp.float32):
    return jnp.asarray(x, dtype)


# the offsets are traced: one compile per dtype and mask serves every hop
_jax_hop_fwd, _jax_hop_bwd = (
    jax.jit(functools.partial(fn, interpret=True),
            static_argnames=("scale", "causal"))
    for fn in (jax_attention.flash_hop_fwd, jax_attention.flash_hop_bwd))


@pytest.mark.parametrize("hop", sorted(HOPS))
@pytest.mark.parametrize("dname", sorted(DTYPES))
def test_hop_forward_matches_jax_kernel(dname, hop):
    q, k, v, _, m, l, acc, _, _ = _hop_inputs(dname, hop, seed=1)
    qo, ko, causal = HOPS[hop]
    tdt, jdt = DTYPES[dname]
    kw = dict(q_offset=qo, k_offset=ko, scale=D ** -0.5, causal=causal)
    want = _jax_hop_fwd(
        *(_jax(x, jdt) for x in (q, k, v)), _jax(m[..., None]),
        _jax(l[..., None]), _jax(acc), **kw)
    want = [np.asarray(x) for x in want]
    got = attention.flash_hop_fwd(*(_torch(x, tdt) for x in (q, k, v)),
                                  *(_torch(x) for x in (m, l, acc)), **kw)
    assert all(x.dtype == torch.float32 for x in got)
    if hop == "dead":       # the state passes a dead hop bit for bit
        for name, g, x in zip("m l acc".split(), got, (m, l, acc)):
            np.testing.assert_array_equal(g.numpy(), x, err_msg=name)
    _close(got[0].numpy(), want[0][..., 0], 1e-5, "m")
    _close(got[1].numpy(), want[1][..., 0], 1e-5, "l")
    _close(got[2].numpy(), want[2], TOL_HOP[dname], "acc")


@pytest.mark.parametrize("hop", sorted(HOPS))
@pytest.mark.parametrize("dname", sorted(DTYPES))
def test_hop_backward_matches_jax_kernels(dname, hop):
    q, k, v, do, _, _, _, lse, dsum = _hop_inputs(dname, hop, seed=2)
    qo, ko, causal = HOPS[hop]
    tdt, jdt = DTYPES[dname]
    kw = dict(q_offset=qo, k_offset=ko, scale=D ** -0.5, causal=causal)
    want = _jax_hop_bwd(
        *(_jax(x, jdt) for x in (q, k, v, do)), _jax(lse[..., None]),
        _jax(dsum[..., None]), **kw)
    args = (*(_torch(x, tdt) for x in (q, k, v, do)), _torch(lse),
            _torch(dsum))
    got = attention.flash_hop_bwd(*args, **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float32
        _close(g.numpy(), np.asarray(w), TOL_HOP[dname], name)
    # a carried sum takes the partial added to it
    carried = [torch.ones_like(g) for g in got]
    summed = attention.flash_hop_bwd(*args, dq=carried[0], dk=carried[1],
                                     dv=carried[2], **kw)
    for s, g in zip(summed, got):
        torch.testing.assert_close(s, g + 1.0, rtol=0, atol=0)


# the kernel paths hand raw pointers to the card, so a tensor that lies
# off q's device must raise before anything is built or launched; the
# meta device stands in for another device here
_KERNEL_CALLS = {
    "hop_fwd": lambda t: attention._hop_fwd_kernel(
        t["q"], t["k"], t["v"], t["m"], t["l"], t["acc"], q_offset=0,
        k_offset=0, scale=0.125, causal=True),
    "hop_dq": lambda t: attention._hop_dq_kernel(
        t["q"], t["k"], t["v"], t["do"], t["lse"], t["dsum"], q_offset=0,
        k_offset=0, scale=0.125, causal=True, dq=t["dq"]),
    "hop_dkv": lambda t: attention._hop_dkv_kernel(
        t["q"], t["k"], t["v"], t["do"], t["lse"], t["dsum"], q_offset=0,
        k_offset=0, scale=0.125, causal=True, dk=t["dk"], dv=t["dv"]),
    "flash_dq": lambda t: attention._dq_kernel(
        t["q"], t["k"], t["v"], t["do"], t["lse"], t["dsum"], scale=0.125,
        causal=True),
}


@pytest.mark.parametrize("call, name", [
    ("hop_fwd", "k"), ("hop_fwd", "m"), ("hop_fwd", "acc"),
    ("hop_dq", "do"), ("hop_dq", "lse"), ("hop_dq", "dq"),
    ("hop_dkv", "dsum"), ("hop_dkv", "dv"), ("flash_dq", "lse")])
def test_kernels_refuse_a_tensor_off_qs_device(call, name):
    t = {x: torch.zeros(1, 1, 8, 64, dtype=torch.bfloat16)
         for x in ("q", "k", "v", "do")}
    t.update({x: torch.zeros(1, 1, 8) for x in ("m", "l", "lse", "dsum")})
    t.update({x: torch.zeros(1, 1, 8, 64) for x in ("acc", "dq", "dk",
                                                    "dv")})
    t[name] = t[name].to("meta")
    before = (attention.hop_fwd_launches, attention.hop_dq_launches,
              attention.hop_dkv_launches, attention.bwd_dq_launches)
    with pytest.raises(ValueError, match="device"):
        _KERNEL_CALLS[call](t)
    assert before == (attention.hop_fwd_launches, attention.hop_dq_launches,
                      attention.hop_dkv_launches, attention.bwd_dq_launches)


def _mesh():
    return Mesh(np.asarray(jax.devices()[:N]), (SEQ,))


def _ring_inputs(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, T, H, D), dtype=np.float32)
            for _ in range(4)]   # q, k, v and the output's cotangent


@functools.lru_cache(maxsize=None)
def _jax_ring(impl, causal, q_chunk):
    """JAX ring attention over 4 devices: ``(out, (dq, dk, dv))`` for
    the cotangent ``probe``."""
    q, k, v, probe = _ring_inputs()
    blocks = dict(block_q=TL, block_k=TL) if impl == "flash" else {}
    fn = shard_map(
        functools.partial(jax_ring_attention, axis_name=SEQ,
                          causal=causal, q_chunk=q_chunk, impl=impl,
                          **blocks),
        mesh=_mesh(), in_specs=(P(None, SEQ),) * 3,
        out_specs=P(None, SEQ), check_vma=impl != "flash")

    @jax.jit
    def run(q, k, v, probe):
        out, vjp = jax.vjp(fn, q, k, v)
        return out, vjp(probe)

    out, grads = run(q, k, v, probe)
    return np.asarray(out), tuple(np.asarray(g) for g in grads)


def _port_ring(ring_, impl, causal, q_chunk, q, k, v, probe):
    leaves = [_torch(x).requires_grad_() for x in (q, k, v)]
    out = ring.ring_attention(*leaves, axis_name=ring_, causal=causal,
                              q_chunk=q_chunk, impl=impl)
    out.backward(_torch(probe))
    return out.detach(), [x.grad for x in leaves]


RING_CASES = [("xla", True, None), ("xla", False, None), ("xla", True, 4),
              ("xla", False, 4), ("flash", True, None),
              ("flash", False, None)]


@pytest.mark.parametrize("impl,causal,q_chunk", RING_CASES)
def test_in_process_ring_matches_jax_ring(impl, causal, q_chunk):
    want_out, want_grads = _jax_ring(impl, causal, q_chunk)
    hops = attention.hop_fwd_launches, attention.hop_dq_launches
    out, grads = _port_ring(ring.InProcessRing(N), impl, causal, q_chunk,
                            *_ring_inputs())
    # CPU tensors take the plain versions: no kernel launch is counted
    assert (attention.hop_fwd_launches, attention.hop_dq_launches) == hops
    np.testing.assert_allclose(out.numpy(), want_out, rtol=TOL_OUT,
                               atol=TOL_OUT)
    for name, g, w in zip(("dq", "dk", "dv"), grads, want_grads):
        np.testing.assert_allclose(g.numpy(), w, rtol=TOL_GRAD,
                                   atol=TOL_GRAD, err_msg=name)


def test_ring_runs_every_hop_in_ring_order(monkeypatch):
    """n^2 forward and n^2 backward hops for an in-process ring of n,
    rank r meeting block (r + s) % n at step s, a dead hop included."""
    seen = {"fwd": [], "bwd": []}
    fwd, bwd = attention.flash_hop_fwd, attention.flash_hop_bwd

    def spy_fwd(*a, q_offset, k_offset, **kw):
        seen["fwd"].append((q_offset // TL, k_offset // TL))
        return fwd(*a, q_offset=q_offset, k_offset=k_offset, **kw)

    def spy_bwd(*a, q_offset, k_offset, **kw):
        seen["bwd"].append((q_offset // TL, k_offset // TL))
        return bwd(*a, q_offset=q_offset, k_offset=k_offset, **kw)

    monkeypatch.setattr(attention, "flash_hop_fwd", spy_fwd)
    monkeypatch.setattr(attention, "flash_hop_bwd", spy_bwd)
    _port_ring(ring.InProcessRing(N), "flash", True, None, *_ring_inputs())
    order = [(r, (r + s) % N) for s in range(N) for r in range(N)]
    assert seen == {"fwd": order, "bwd": order}


@pytest.mark.parametrize("causal,q_chunk", [(True, 8), (False, None)])
def test_blockwise_matches_jax(causal, q_chunk):
    q, k, v, probe = _ring_inputs(seed=3)

    @jax.jit
    def run(q, k, v, probe):
        fn = functools.partial(jax_blockwise_attention, causal=causal,
                               q_chunk=q_chunk)
        out, vjp = jax.vjp(fn, q, k, v)
        return out, vjp(probe)

    want_out, want_grads = run(q, k, v, probe)
    leaves = [_torch(x).requires_grad_() for x in (q, k, v)]
    out = ring.blockwise_attention(*leaves, causal=causal, q_chunk=q_chunk)
    out.backward(_torch(probe))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               rtol=TOL_OUT, atol=TOL_OUT)
    for name, g, w in zip(("dq", "dk", "dv"), leaves, want_grads):
        np.testing.assert_allclose(g.grad.numpy(), np.asarray(w),
                                   rtol=TOL_GRAD, atol=TOL_GRAD,
                                   err_msg=name)


# ---- the model ---------------------------------------------------------


def _tokens(seed=4):
    data = np.random.default_rng(seed).integers(0, LM["vocab_size"],
                                                (B, T + 1))
    return data[:, :-1].astype(np.int32), data[:, 1:].astype(np.int32)


@functools.lru_cache(maxsize=None)
def _jax_lm():
    """JAX ``TransformerLM(seq_axis="seq")`` over 4 devices from the
    dense twin's init, under the ``shard_map`` its
    ``sequence_sharded_apply`` builds (params replicated, time sharded)
    plus the JAX tests' ``pmean`` of the loss: ``(params, logits, loss,
    grads)`` as numpy."""
    tokens, targets = _tokens()
    spec = functools.partial(jax_model_config, "transformer_lm", (T,),
                             input_dtype="int32", **LM)
    dense = ModelSpec.from_config(spec()).build()
    seq = ModelSpec.from_config(spec(seq_axis=SEQ)).build()
    variables = jax.jit(dense.init)(jax.random.key(5), tokens)
    loss_fn = jax_resolve_loss("sparse_categorical_crossentropy")

    def shard_loss(vs, toks, tgt):
        logits = seq.apply(vs, toks)
        return jax.lax.pmean(loss_fn(logits, tgt), SEQ), logits

    # the loss as the JAX tests take it, the logits as its
    # sequence_sharded_apply returns them (time axis sharded)
    sharded = shard_map(shard_loss, mesh=_mesh(),
                        in_specs=(P(), P(None, SEQ), P(None, SEQ)),
                        out_specs=(P(), P(None, SEQ)))
    (loss, logits), grads = jax.jit(jax.value_and_grad(
        sharded, has_aux=True))(variables, tokens, targets)
    as_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    return (as_np(variables["params"]), np.asarray(logits), float(loss),
            as_np(grads["params"]))


def _port_lm(**over):
    model = build_model(model_config("transformer_lm", (T,),
                                     input_dtype="int32",
                                     **{**LM, **over}), device="cpu")
    params, *_ = _jax_lm()
    model.load_state_dict(convert.params_from_flax(params))
    return model


def test_seq_model_has_the_dense_parameters():
    """``convert`` needs no change: the sequence-parallel model's
    parameters are the dense model's, and the flax tree loads strictly."""
    seq, dense = _port_lm(seq_axis=SEQ), _port_lm()
    assert {n: p.shape for n, p in seq.state_dict().items()} \
        == {n: p.shape for n, p in dense.state_dict().items()}
    for n, p in seq.state_dict().items():
        torch.testing.assert_close(p, dense.state_dict()[n], rtol=0, atol=0)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_seq_model_matches_jax(impl):
    """Logits and the step-1 gradient of the LM loss through the ring of
    4, against the JAX model under its ``sequence_sharded_apply``."""
    over = {} if impl == "xla" else {"attn_fn": ring.ring_attn_fn(
        SEQ, impl="flash")}
    model = _port_lm(seq_axis=SEQ, **over)
    _, want_logits, want_loss, want_grads = _jax_lm()
    tokens, targets = _tokens()
    loss_fn = resolve_loss("sparse_categorical_crossentropy")

    def step(_, toks, tgt):
        logits = model(toks)
        loss = loss_fn(logits, tgt)
        loss.backward()
        return logits.detach(), loss.detach()

    logits, loss = ring.sequence_sharded_apply(
        step, ring.InProcessRing(N), SEQ, num_seq_args=2)(
            None, _torch(tokens, torch.long), _torch(targets, torch.long))
    np.testing.assert_allclose(logits.numpy(), want_logits, rtol=2e-5,
                               atol=2e-5)
    assert abs(float(loss) - want_loss) <= 2e-6 * abs(want_loss)
    want = convert.params_from_flax(want_grads)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=name)


@functools.lru_cache(maxsize=None)
def _jax_blockwise_lm():
    cfg = jax_model_config("transformer_lm", (T,), input_dtype="int32",
                           blockwise_attn=True, attn_q_chunk=8, **LM)
    params, *_ = _jax_lm()
    return np.asarray(jax.jit(ModelSpec.from_config(cfg).build().apply)(
        {"params": params}, _tokens()[0]))


@pytest.mark.parametrize("spelling", [dict(blockwise_attn=True),
                                      dict(attn="blockwise")])
def test_blockwise_model_matches_jax(spelling):
    tokens, _ = _tokens()
    want = _jax_blockwise_lm()
    model = _port_lm(attn_q_chunk=8, **spelling)
    with torch.no_grad():
        got = model(_torch(tokens, torch.long))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_generate_clears_the_ring():
    """``generate()`` serves a seq_axis model as its dense twin."""
    prompt = _tokens()[0][:, :5]
    got = generate(_port_lm(seq_axis=SEQ), prompt, max_new_tokens=4,
                   device="cpu")
    want = generate(_port_lm(), prompt, max_new_tokens=4, device="cpu")
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def _bound(fn):
    return ring.sequence_sharded_apply(lambda _: fn(), ring.InProcessRing(N),
                                       SEQ)(None)


_QKV = [torch.zeros(B, T, H, D) for _ in range(3)]
RAISES = {
    "unbound axis": lambda: ring.ring_attention(*_QKV, axis_name=SEQ),
    "unbound model axis": lambda: _port_lm(seq_axis=SEQ)(
        torch.zeros(B, T, dtype=torch.long)),
    "unknown impl": lambda: ring.ring_attention(*_QKV, axis_name=None,
                                                impl="mosaic"),
    "q_chunk not a divisor": lambda: _bound(lambda: ring.ring_attention(
        *_QKV, axis_name=SEQ, q_chunk=3)),
    "seq_axis with flash_attn": lambda: _port_lm(seq_axis=SEQ,
                                                 flash_attn=True),
    "seq_axis with blockwise_attn": lambda: _port_lm(seq_axis=SEQ,
                                                     blockwise_attn=True),
    "seq_axis with attn": lambda: _port_lm(seq_axis=SEQ, attn="dense"),
    "blockwise and flash": lambda: _port_lm(blockwise_attn=True,
                                            flash_attn=True),
    "decode with seq_axis": lambda: _port_lm(seq_axis=SEQ, decode=True),
    "cache with seq_axis": lambda: _bound(lambda: _port_lm(seq_axis=SEQ)(
        torch.zeros(1, 4, dtype=torch.long),
        cache=_port_lm().new_cache(1))),
    "ring longer than max_len": lambda: ring.sequence_sharded_apply(
        lambda _, t: _port_lm(seq_axis=SEQ)(t), _FakeRank(1, N), SEQ)(
            None, torch.zeros(B, 2 * T, dtype=torch.long)),
}


class _FakeRank(ring.InProcessRing):
    """Rank ``r`` of an ``n``-rank ring, as a process of a group sees it."""

    def __init__(self, r, n):
        super().__init__(n)
        self.ranks = (r,)


@pytest.mark.parametrize("case", sorted(RAISES))
def test_raises(case):
    with pytest.raises(ValueError):
        RAISES[case]()


def test_rank_block_positions():
    """Under a one-rank-per-process ring, rank r's tokens sit at global
    positions r * T_local + t: its logits are the ring's rows for it."""
    model = _port_lm(seq_axis=SEQ)
    tokens = _torch(_tokens()[0], torch.long)
    with torch.no_grad():
        whole = ring.sequence_sharded_apply(
            lambda _, t: model(t), ring.InProcessRing(N), SEQ)(None, tokens)
        # rank 0's block needs no other rank under causal attention
        first = ring.sequence_sharded_apply(
            lambda _, t: model(t), _FakeRank(0, N), SEQ)(None, tokens)
    torch.testing.assert_close(first, whole[:, :TL], rtol=1e-6, atol=1e-6)


# ---- the torch.distributed ring: 4 gloo processes ----------------------

_CHILD = r'''
import sys
import torch
import torch.distributed as dist

rank, tmp, root = int(sys.argv[1]), sys.argv[2], sys.argv[3]
sys.path.insert(0, root)
torch.set_num_threads(1)
from distkeras_tpu_torch import build_model
from distkeras_tpu_torch.models import model_config
from distkeras_tpu_torch.ops.losses import resolve_loss
from distkeras_tpu_torch.parallel import ring_attention as ring

dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous",
                        rank=rank, world_size=4)
ref = torch.load(f"{tmp}/ref.pt")
pg = ring.ProcessGroupRing()
tl = ref["q"].shape[1] // pg.size
mine = slice(rank * tl, (rank + 1) * tl)
tol = dict(rtol=ref["tol_out"], atol=ref["tol_out"])
gtol = dict(rtol=ref["tol_grad"], atol=ref["tol_grad"])
for impl in ("xla", "flash"):
    leaves = [ref[n][:, mine].clone().requires_grad_() for n in "qkv"]
    out = ring.ring_attention(*leaves, axis_name=pg, impl=impl)
    out.backward(ref["probe"][:, mine])
    torch.testing.assert_close(out.detach(), ref[f"{impl}/out"][:, mine],
                               **tol)
    for n, x in zip("qkv", leaves):
        torch.testing.assert_close(x.grad, ref[f"{impl}/d{n}"][:, mine],
                                   **gtol)
        # the same hops and carries as the in-process ring: same bits
        assert torch.equal(x.grad, ref[f"{impl}/port_d{n}"][:, mine]), n
    assert torch.equal(out.detach(), ref[f"{impl}/port_out"][:, mine])

model = build_model(model_config("transformer_lm", (ref["tokens"].shape[1],),
                                 input_dtype="int32", seq_axis="seq",
                                 **ref["lm"]), device="cpu")
model.load_state_dict(ref["params"])
loss_fn = resolve_loss("sparse_categorical_crossentropy")
loss = ring.sequence_sharded_apply(
    lambda _, toks, tgt: loss_fn(model(toks), tgt), pg, "seq",
    num_seq_args=2)(None, ref["tokens"], ref["targets"])
loss.backward()
dist.all_reduce(loss)
torch.testing.assert_close(loss / pg.size, ref["loss"], rtol=2e-6, atol=0)
for name, p in model.named_parameters():
    dist.all_reduce(p.grad)
    torch.testing.assert_close(p.grad / pg.size, ref["grads"][name],
                               rtol=1e-4, atol=1e-6, msg=name)
dist.destroy_process_group()
print("ok", rank)
'''


def test_process_group_ring_matches_jax(tmp_path):
    """Ring form (a): 4 gloo processes, rank r holding block r, run ring
    attention forward and backward (both impls) and one LM gradient
    (the local loss and its gradient averaged over the ring, as the JAX
    ``pmean``), against the JAX values and the in-process ring's bits."""
    q, k, v, probe = _ring_inputs()
    ref = {n: _torch(x) for n, x in zip(("q", "k", "v", "probe"),
                                        (q, k, v, probe))}
    for impl in ("xla", "flash"):
        out, grads = _jax_ring(impl, True, None)
        ref[f"{impl}/out"] = _torch(out)
        port_out, port_grads = _port_ring(ring.InProcessRing(N), impl, True,
                                          None, q, k, v, probe)
        ref[f"{impl}/port_out"] = port_out
        for n, g, pg in zip("qkv", grads, port_grads):
            ref[f"{impl}/d{n}"] = _torch(g)
            ref[f"{impl}/port_d{n}"] = pg
    params, _, loss, grads = _jax_lm()
    tokens, targets = _tokens()
    ref.update(tokens=_torch(tokens, torch.long),
               targets=_torch(targets, torch.long), lm=LM,
               params=convert.params_from_flax(params),
               grads=convert.params_from_flax(grads),
               loss=torch.tensor(loss), tol_out=TOL_OUT, tol_grad=TOL_GRAD)
    torch.save(ref, tmp_path / "ref.pt")
    procs = [subprocess.Popen([sys.executable, "-c", _CHILD, str(r),
                               str(tmp_path), str(ROOT)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(N)]
    reports = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=180)
        except subprocess.TimeoutExpired:
            for other in procs:
                other.kill()
            raise
        reports.append((p.returncode, out, err[-3000:]))
    assert all(rc == 0 for rc, _, _ in reports), reports
