#!/usr/bin/env python3
"""Chip smoke of distkeras_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py [--out PATH]

Phases, in order; any failure exits nonzero and prints no result:

1. build every CUDA kernel of the serving and training paths from
   ``csrc/`` (one ``nvcc`` per source, all started together) and print
   the card's name and power limit;
2. hold each kernel against its plain PyTorch version on the card at
   the paths' shapes (and a few more), with the tolerances below, and
   time kernel, plain version and the one PyTorch call that computes
   the same function (``library_ms``, timed here and used nowhere in
   the port);
3. serve 16 requests through ``DecodeEngine`` with the GPT-2-small
   shaped LM (L12, d768, 12 heads, 4 KV heads, vocab 32768, max_len
   2048, bf16, flash prefill) on seeded random weights mapped through
   ``convert.params_from_flax``; each request's greedy tokens must
   equal ``generate()`` on the same prompt, and the forward kernel's
   launch count over the run must be 12 per admission;
   the same traffic is then served once more under ``torch.profiler``
   for the device's busy share and time by kernel;
4. train the GPT-2-small LM (L12, d768, 12 heads, vocab 32768, T 1024,
   bf16, ``flash_attn=True``) through ``SingleTrainer`` for 2 epochs of
   16 steps (batch 8, adam 3e-4) from seeded random weights: the epoch
   loss must fall, every loss and gradient norm be finite, each of the
   three kernels launch exactly 12 times per step, and the first 3
   steps' losses and step 1's gradient norm equal those of the same
   trainer with ``attn="dense"`` (trained on those 3 batches) within
   ``TOL_TRAIN_LOSS``/``TOL_TRAIN_GNORM``, as does step 1's gradient of
   every parameter within ``TOL_TRAIN_GRAD``; then step time, tokens/s,
   analytic MFU and the device's idle share over a few steps under
   ``torch.profiler``;
5. print the kernel table as one JSON line, then the device line last.

Exits nonzero without a CUDA device, and where the package is missing
beside this file.  ``--out`` also writes the per-shape details as JSON.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

TOL_OUT = {"bfloat16": 2e-2, "float32": 2e-5}  # max |out - plain|
TOL_LSE = 1e-4     # max |lse - plain|, f32 statistics in both dtypes
# dq, dk, dv per element: |grad - plain| <= TOL_GRAD * (|plain| +
# rms(plain)).  bf16: each side rounds its f32 sum once (half an ulp,
# 2^-8 of |plain|), and a one-ulp flip of a rounded ds or p moves a sum
# of many terms by a small share of its typical size, rms(plain); 2^-6
# leaves twice that room.  f32: summation order and expf against
# torch.exp.  The typical size, not the largest entry, sets the scale,
# so a wrong tile late in a causal sequence (small rows) still fails
TOL_GRAD = {"bfloat16": 2 ** -6, "float32": 1e-5}
# |loss(flash) - loss(dense)| over the first 3 training steps: the dense
# path rounds its attention logits to bf16 (relative 2^-8), the kernels
# keep them in f32; that moved losses near ln(32768) = 10.4 by 8.2e-5 on
# an H100 80GB HBM3 at 700 W (PERF.md)
TOL_TRAIN_LOSS = 1e-3
# step 1's gradients, flash against dense from the same start on the
# same batch: the global norm (the trainer's grad_norm) within 1e-2,
# each parameter's within 5e-2 in norm, both relative, for the same
# rounding of the dense path's logits.  The key biases get no gradient
# in exact arithmetic (softmax ignores a shift common to all keys):
# theirs is rounding noise, held below 1e-3 of the whole gradient's norm
TOL_TRAIN_GNORM, TOL_TRAIN_GRAD = 1e-2, 5e-2
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # H100 SXM, dense
PEAK_BYTES = 3.35e12

LM = dict(vocab_size=32768, num_layers=12, d_model=768, num_heads=12,
          num_kv_heads=4, mlp_ratio=4, max_len=2048, dtype="bfloat16",
          flash_attn=True)
# the training path: scripts/perf_lm.py --attn flash, through SingleTrainer
TRAIN_LM = dict(vocab_size=32768, num_layers=12, d_model=768, num_heads=12,
                mlp_ratio=4, max_len=1024, dtype="bfloat16",
                flash_attn=True)
TRAIN = dict(loss="sparse_categorical_crossentropy", worker_optimizer="adam",
             learning_rate=3e-4, batch_size=8)
TRAIN_ROWS, TRAIN_EPOCHS = 128, 2   # 16 steps per epoch
BWD_SHAPE = (8, 12, 1024, 64)       # the training path's attention


def _card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def _time_ms(fn, iters: int) -> float:
    """Device time of one ``fn()`` call: ``iters`` calls captured in a
    CUDA graph, replayed between CUDA events, so the host's cost of
    issuing each call (tens of microseconds in eager PyTorch, more than
    a small kernel takes) stays out of the reading."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _profiled_ms(fn, iters: int) -> float:
    """Device time of one ``fn()`` call: the summed device time of its
    kernels under ``torch.profiler`` over ``iters`` calls.  For calls
    that graph capture does not take (autograd replays the forward's
    streams) and whose host issue time would show in an event reading
    (the backward of SDPA)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(_device_kernels(prof, torch).values()) / iters


def _attn_bound(b, h, t, d, dtype, causal):
    """Least time (ms) and what bounds it: q, k, v read once, out and
    lse written once; causal work counts the causal half."""
    item = 2 if dtype == "bfloat16" else 4
    flops = 4 * b * h * t * t * d * (0.5 if causal else 1.0)
    nbytes = 4 * b * h * t * d * item + b * h * t * 4
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _bwd_bound(b, h, t, d, dtype, causal, products, outputs):
    """Least time (ms) and what bounds it for a backward function that
    does ``products`` T x T x D products per head and writes
    ``outputs`` [B, H, T, D] tensors: q, k, v, do read once, lse and
    dsum read once, the outputs written once; causal work counts the
    causal half."""
    item = 2 if dtype == "bfloat16" else 4
    flops = 2 * products * b * h * t * t * d * (0.5 if causal else 1.0)
    nbytes = (4 + outputs) * b * h * t * d * item + 2 * b * h * t * 4
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


# each backward kernel's function: T x T x D products per head, outputs
BWD_WORK = {"flash_attention_bwd_dq": (3, 1),      # qk^T, do.v^T, ds.k
            "flash_attention_bwd_dkv": (4, 2)}     # + p^T.do, ds^T.q


def _bwd_case(attention, torch, gen, shape, dtype, causal):
    b, h, t, d = shape
    q, k, v, dout = (torch.randn(b, h, t, d, device="cuda", dtype=dtype,
                                 generator=gen) for _ in range(4))
    scale = d ** -0.5
    out, lse = attention.flash_attention_reference(q, k, v, scale=scale,
                                                   causal=causal)
    do, dsum = attention._bwd_inputs(q, out, dout)
    return q, k, v, do, lse, dsum, scale


def _check_attention_bwd(attention, torch, shapes):
    """Backward kernels vs their plain versions on the card."""
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(2)
    for shape in shapes:
        for dname in ("bfloat16", "float32"):
            for causal in (True, False):
                q, k, v, do, lse, dsum, scale = _bwd_case(
                    attention, torch, gen, shape, getattr(torch, dname),
                    causal)
                kw = dict(scale=scale, causal=causal)
                got = (attention.flash_attention_bwd_dq(
                    q, k, v, do, lse, dsum, **kw),
                    *attention.flash_attention_bwd_dkv(
                        q, k, v, do, lse, dsum, **kw))
                want = (attention.flash_attention_bwd_dq_reference(
                    q, k, v, do, lse, dsum, **kw),
                    *attention.flash_attention_bwd_dkv_reference(
                        q, k, v, do, lse, dsum, **kw))
                torch.cuda.synchronize()
                row = {"shape": list(shape), "dtype": dname,
                       "causal": causal}
                ok = True
                for name, a, w in zip(("dq", "dk", "dv"), got, want):
                    a, w = a.float(), w.float()
                    diff = (a - w).abs()
                    rms = w.square().mean().sqrt()
                    ratio = (diff / (w.abs() + rms)).max().item()
                    row[f"{name}_err"] = diff.max().item()
                    row[f"{name}_rms"] = rms.item()
                    row[f"{name}_ratio"] = ratio
                    ok = (ok and ratio <= TOL_GRAD[dname]
                          and bool(torch.isfinite(a).all()))
                row["ok"] = ok
                print(f"attention_bwd {row}")
                if not ok:
                    raise SystemExit(
                        f"flash_attention_bwd disagrees with its plain "
                        f"version: {row}")
                rows.append(row)
    return rows


def _time_attention_bwd(attention, torch, F, shape):
    """dq and dk/dv kernel, their plain versions and the backward of
    SDPA (ms) at the training path's shape, bf16 causal."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    q, k, v, do, lse, dsum, scale = _bwd_case(
        attention, torch, gen, shape, torch.bfloat16, True)
    kw = dict(scale=scale, causal=True)
    # SDPA's backward: the same dq, dk, dv from the same q, k, v, dout
    ql, kl, vl = (x.detach().clone().requires_grad_() for x in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True,
                                              scale=scale)
    library = _profiled_ms(lambda: torch.autograd.grad(
        sdpa_out, (ql, kl, vl), do, retain_graph=True), 20)
    out = {}
    for name, kernel, plain in (
            ("flash_attention_bwd_dq", attention.flash_attention_bwd_dq,
             attention.flash_attention_bwd_dq_reference),
            ("flash_attention_bwd_dkv", attention.flash_attention_bwd_dkv,
             attention.flash_attention_bwd_dkv_reference)):
        ms = _time_ms(lambda: kernel(q, k, v, do, lse, dsum, **kw), 10)
        plain_ms = _time_ms(lambda: plain(q, k, v, do, lse, dsum, **kw), 3)
        bound, by = _bwd_bound(*shape, "bfloat16", True, *BWD_WORK[name])
        out[name] = {"ms": ms, "plain_ms": plain_ms, "library_ms": library,
                     "bound_ms": bound, "bound_by": by}
        print(f"timing {name} {list(shape)} bf16 causal: kernel {ms:.4f} "
              f"ms, plain {plain_ms:.4f} ms, sdpa backward {library:.4f} "
              f"ms, bound {bound:.5f} ms ({by})")
    whole, by = _bwd_bound(*shape, "bfloat16", True, 5, 3)
    print(f"timing flash backward as a whole {list(shape)}: dq + dkv "
          f"{out['flash_attention_bwd_dq']['ms'] + out['flash_attention_bwd_dkv']['ms']:.4f}"
          f" ms, bound of the whole backward (5 products) {whole:.5f} ms "
          f"({by})")
    return out, {"bound_ms": whole, "bound_by": by}


def _check_attention(attention, torch, shapes):
    """Kernel vs plain version on the card; returns per-case rows."""
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(0)
    for (b, h, t, d) in shapes:
        for dname in ("bfloat16", "float32"):
            dtype = getattr(torch, dname)
            q, k, v = (torch.randn(b, h, t, d, device="cuda", dtype=dtype,
                                   generator=gen) for _ in range(3))
            scale = d ** -0.5
            for causal in (True, False):
                out, lse = attention.flash_attention_bhtd(
                    q, k, v, scale=scale, causal=causal)
                ref, ref_lse = attention.flash_attention_reference(
                    q, k, v, scale=scale, causal=causal)
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs().max().item()
                lerr = (lse - ref_lse).abs().max().item()
                ok = (err <= TOL_OUT[dname] and lerr <= TOL_LSE
                      and bool(torch.isfinite(out).all()))
                row = {"shape": [b, h, t, d], "dtype": dname,
                       "causal": causal, "max_abs_err": err,
                       "lse_err": lerr, "ok": ok}
                print(f"attention {row}")
                if not ok:
                    raise SystemExit(
                        f"flash_attention_fwd disagrees with its plain "
                        f"version: {row}")
                rows.append(row)
    return rows


def _time_attention(attention, torch, F, shapes):
    """Kernel, plain and SDPA times (ms) for bf16 causal shapes."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    out = {}
    for (b, h, t, d) in shapes:
        q, k, v = (torch.randn(b, h, t, d, device="cuda",
                               dtype=torch.bfloat16, generator=gen)
                   for _ in range(3))
        scale = d ** -0.5
        iters = max(5, int(4e5 // max(t, 1)))
        ms = _time_ms(lambda: attention.flash_attention_bhtd(
            q, k, v, scale=scale, causal=True), iters)
        plain = _time_ms(lambda: attention.flash_attention_reference(
            q, k, v, scale=scale, causal=True), max(5, iters // 10))
        lib = _time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, scale=scale), iters)
        bound, by = _attn_bound(b, h, t, d, "bfloat16", True)
        out[(b, h, t, d)] = {"ms": ms, "plain_ms": plain,
                             "library_ms": lib, "bound_ms": bound,
                             "bound_by": by}
        print(f"timing [{b},{h},{t},{d}] bf16 causal: kernel {ms:.4f} ms, "
              f"plain {plain:.4f} ms, sdpa {lib:.4f} ms, "
              f"bound {bound:.5f} ms ({by})")
    return out


def _profile_serve(engine, reqs, torch):
    """Serve ``reqs`` once under ``torch.profiler`` (device activity
    only, which keeps the trace small): the device's busy time and its
    split by kernel and by class (the flash kernel, matrix products,
    everything else)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        list(engine.run(reqs))
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    return _by_class(_device_kernels(prof, torch), wall, "profile")


# device kernels by class: the port's three (anonymous-namespace CUDA
# kernels), cuBLAS matrix products, everything else
KERNEL_CLASSES = (("flash_attention_fwd", ("::fwd_kernel<",)),
                  ("flash_attention_bwd_dq", ("::dq_kernel<",)),
                  ("flash_attention_bwd_dkv", ("::dkv_kernel<",)),
                  ("matmul", ("nvjet", "gemm", "xmma", "cutlass")))


def _by_class(kernels, wall, tag):
    busy_ms = sum(kernels.values())
    classes = {name: 0.0 for name, _ in KERNEL_CLASSES}
    classes["other"] = 0.0
    for kname, ms in kernels.items():
        cls = next((name for name, marks in KERNEL_CLASSES
                    if any(m in kname for m in marks)), "other")
        classes[cls] += ms
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
    print(f"{tag}: wall_s={wall:.3f} device_busy_ms={busy_ms:.3f} "
          f"kernels={len(kernels)} by class (ms): "
          + " ".join(f"{k}={v:.3f}" for k, v in classes.items()))
    for name, ms in top:
        print(f"{tag}:   {ms:9.3f} ms  {name[:90]}")
    return {"wall_s": wall, "device_busy_ms": busy_ms,
            "by_class_ms": classes, "top_kernels_ms": dict(top)}


def _device_kernels(prof, torch):
    kernels = {}
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels[ev.key] = ev.self_device_time_total / 1e3
    if sum(kernels.values()) <= 0:
        raise SystemExit("profiler saw no device time")
    return kernels


def _counts(attention):
    return {"flash_attention_fwd": attention.launches,
            "flash_attention_bwd_dq": attention.bwd_dq_launches,
            "flash_attention_bwd_dkv": attention.bwd_dkv_launches}


def _reset_counts(attention):
    attention.launches = 0
    attention.bwd_dq_launches = 0
    attention.bwd_dkv_launches = 0


def _lm_flops(cfg, n_params, batch):
    """perf_lm.py's analytic training FLOPs per step: 6 * params *
    tokens, and the attention term 12 * L * d * T^2 * B (fwd + bwd)."""
    t = cfg["max_len"]
    return (6.0 * n_params * batch * t,
            12.0 * cfg["num_layers"] * cfg["d_model"] * t * t * batch)


def _train(seed, torch, np):
    """Phase 4: the training path through ``SingleTrainer``; returns its
    numbers and the three kernels' launch counts over the run."""
    from torch.profiler import ProfilerActivity, profile

    from distkeras_tpu_torch import Dataset, SingleTrainer, convert
    from distkeras_tpu_torch.data import datasets
    from distkeras_tpu_torch.models import model_config
    from distkeras_tpu_torch.ops import attention
    from distkeras_tpu_torch.workers import (TrainState, make_train_step,
                                             resolve_optimizer)

    t_phase = time.monotonic()
    t = TRAIN_LM["max_len"]
    data = datasets.lm_synth(TRAIN_ROWS, seq_len=t,
                             vocab_size=TRAIN_LM["vocab_size"], seed=seed)
    start = convert.params_from_flax(
        _flax_tree(np.random.default_rng(seed + 2), TRAIN_LM))
    cfg = model_config("transformer_lm", (t,), input_dtype="int32",
                       **TRAIN_LM)
    trainer = SingleTrainer(cfg, num_epoch=TRAIN_EPOCHS, seed=seed, **TRAIN)
    n_params = sum(p.numel() for p in trainer.model.parameters())
    steps = TRAIN_EPOCHS * (TRAIN_ROWS // TRAIN["batch_size"])
    torch.cuda.synchronize()
    _reset_counts(attention)
    trainer.train(data, initial_variables=start)
    torch.cuda.synchronize()
    launches = _counts(attention)
    loss, gnorm = (trainer.step_metrics[k] for k in ("loss", "grad_norm"))
    epochs = trainer.history["epoch_loss"]
    print(f"train: params={n_params} steps={len(loss)} "
          f"epoch_loss={epochs} training_time_s={trainer.training_time:.3f}"
          f" launches={launches}")
    print(f"train: step losses {np.round(loss, 4).tolist()}")
    print(f"train: grad norms {np.round(gnorm, 4).tolist()}")
    want = TRAIN_LM["num_layers"] * steps
    if any(n != want for n in launches.values()):
        raise SystemExit(f"kernel launches on the training path "
                         f"{launches}; expected {want} each")
    if len(loss) != steps or not (np.isfinite(loss).all()
                                  and np.isfinite(gnorm).all()):
        raise SystemExit("non-finite or missing training losses")
    if not epochs[1] < epochs[0]:
        raise SystemExit(f"epoch loss did not fall: {epochs}")

    # the same trainer spelled attn="dense": no custom kernel on its path.
    # It trains on the flash trainer's first 3 batches only: the first n
    # rows of that trainer's epoch order (Dataset.shuffle(seed)), laid
    # out so that the dense trainer's shuffle of n rows with the same
    # seed puts them back in that order
    n = 3 * TRAIN["batch_size"]
    rows = np.random.default_rng(seed).permutation(TRAIN_ROWS)[:n]
    back = np.argsort(np.random.default_rng(seed).permutation(n))
    first = Dataset({k: data[k][rows[back]] for k in data.column_names})
    dense_cfg = model_config("transformer_lm", (t,), input_dtype="int32",
                             **{**TRAIN_LM, "flash_attn": False,
                                "attn": "dense"})
    dense = SingleTrainer(dense_cfg, num_epoch=1, seed=seed, **TRAIN)
    before = _counts(attention)
    dense.train(first, initial_variables=start)
    if _counts(attention) != before:
        raise SystemExit("the dense trainer launched a flash kernel")
    dense_first = dense.step_metrics["loss"]
    diff = np.abs(dense_first - loss[:3])
    gdiff = abs(dense.step_metrics["grad_norm"][0] / gnorm[0] - 1)
    print(f"train: dense first 3 losses "
          f"{dense_first.tolist()} vs flash "
          f"{loss[:3].tolist()}: max |diff| {diff.max():.6g} "
          f"(tolerance {TOL_TRAIN_LOSS}); step 1 grad_norm dense "
          f"{dense.step_metrics['grad_norm'][0]:.6g} vs flash "
          f"{gnorm[0]:.6g}: relative diff {gdiff:.6g} (tolerance "
          f"{TOL_TRAIN_GNORM})")
    if not diff.max() <= TOL_TRAIN_LOSS:
        raise SystemExit("flash and dense training losses disagree")
    if not gdiff <= TOL_TRAIN_GNORM:
        raise SystemExit("flash and dense step-1 gradient norms disagree")
    batch = {k: torch.from_numpy(data[k][rows[:TRAIN["batch_size"]]]).to(
                 trainer.device) for k in ("features", "label")}
    grad_err = _first_grads_agree(trainer.model, dense.model, start, batch,
                                  TRAIN["loss"], torch)
    del dense

    # step time of the trainer's step function on the trained state:
    # each step ends in a synchronize
    tx = resolve_optimizer(TRAIN["worker_optimizer"],
                           TRAIN["learning_rate"])
    state = TrainState.create(trainer.model, trainer.trained_variables, tx,
                              device=trainer.device)
    step = make_train_step(trainer.model, TRAIN["loss"], tx)
    times = []
    for _ in range(6):
        t0 = time.monotonic()
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.monotonic() - t0)
    step_s = float(np.median(times[1:]))
    tokens = TRAIN["batch_size"] * t
    f_param, f_attn = _lm_flops(TRAIN_LM, n_params, TRAIN["batch_size"])
    peak = PEAK_FLOPS["bfloat16"]
    res = {"params": n_params, "steps": int(len(loss)),
           "epoch_loss": epochs, "step_loss": loss.tolist(),
           "grad_norm": gnorm.tolist(),
           "dense_first_losses": dense_first.tolist(),
           "dense_max_abs_diff": float(diff.max()),
           "dense_grad_norm_rel_diff": float(gdiff),
           "step1_grad_rel_err": grad_err,
           "training_time_s": trainer.training_time,
           "step_ms": step_s * 1e3, "step_ms_all": [x * 1e3 for x in times],
           "tokens_per_s": tokens / step_s,
           "mfu_6nd": f_param / step_s / peak,
           "mfu_with_attn": (f_param + f_attn) / step_s / peak}
    print(f"train: step_ms={res['step_ms']:.3f} (median of steps 2-6; all "
          f"{np.round(res['step_ms_all'], 3).tolist()}) tokens_per_s="
          f"{res['tokens_per_s']:.1f} mfu_6nd={res['mfu_6nd']:.4f} "
          f"mfu_with_attn={res['mfu_with_attn']:.4f} (against 989 TFLOP/s)")

    # where a step's time goes: 3 steps under the profiler, against the
    # same 3 steps' unprofiled wall
    t0 = time.monotonic()
    for _ in range(3):
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            state, _ = step(state, batch)
        torch.cuda.synchronize()
    res["profile"] = _by_class(_device_kernels(prof, torch), wall,
                               "train profile")
    res["profile"]["idle_share"] = (
        1.0 - res["profile"]["device_busy_ms"] / 1e3 / wall)
    print(f"train profile: device idle share of 3 steps' wall "
          f"{res['profile']['idle_share']:.4f}")
    res["phase_s"] = time.monotonic() - t_phase
    print(f"train: phase took {res['phase_s']:.1f} s")
    return res, launches


def _first_grads_agree(flash, dense, start, batch, loss, torch):
    """Step 1's gradient of every parameter through ``flash`` against
    ``dense``, from the f32 ``start`` cast to each module's dtypes as
    the training step casts it; raises past ``TOL_TRAIN_GRAD``.  Returns
    the largest relative error by kind of parameter."""
    from torch.func import functional_call

    from distkeras_tpu_torch.ops.losses import resolve_loss

    def grads(model):
        own = dict(model.named_parameters())
        params = {n: start[n].to(device="cuda", dtype=torch.float32)
                  .requires_grad_() for n in own}
        logits = functional_call(model, {n: p.to(own[n].dtype)
                                         for n, p in params.items()},
                                 (batch["features"],))
        out = torch.autograd.grad(resolve_loss(loss)(logits, batch["label"]),
                                  list(params.values()))
        return dict(zip(params, out))

    got, want = grads(flash), grads(dense)
    total = torch.stack([g.norm() for g in want.values()]).norm().item()
    worst: dict = {}
    for name, g in got.items():
        kind = name.split(".")[-2] + "." + name.split(".")[-1]
        if name.endswith("attn.key.bias"):
            err = max(g.norm().item(), want[name].norm().item()) / total
            ok = err <= 1e-3
        else:
            scale = max(want[name].norm().item(), 1e-3 * total)
            err = (g - want[name]).norm().item() / scale
            ok = err <= TOL_TRAIN_GRAD
        worst[kind] = max(worst.get(kind, 0.0), err)
        if not ok:
            raise SystemExit(f"step 1 gradient of {name}: flash against "
                             f"dense relative error {err:.4g}")
    print(f"train: step 1 gradients flash vs dense, largest relative "
          f"error by kind: " + " ".join(f"{k}={v:.3g}"
                                         for k, v in worst.items()))
    return worst


def _flax_tree(rng, cfg):
    """Seeded random params in the JAX package's flax layout (f32)."""
    import numpy as np

    d, h = cfg["d_model"], cfg["num_heads"]
    kvh = cfg.get("num_kv_heads") or h
    hd, hid = d // h, d * cfg["mlp_ratio"]

    def normal(shape, fan_in):
        return (rng.standard_normal(shape, dtype=np.float32)
                * np.float32(fan_in ** -0.5))

    def small(shape):
        return rng.standard_normal(shape, dtype=np.float32) * 0.02

    def ln():
        return {"scale": 1.0 + small((d,)), "bias": small((d,))}

    tree = {"Embed_0": {"embedding": normal((cfg["vocab_size"], d), 1)},
            "pos_embed": {"embedding": normal((cfg["max_len"], d), d)},
            "LayerNorm_0": ln(),
            "lm_head": {"kernel": normal((d, cfg["vocab_size"]), d),
                        "bias": small((cfg["vocab_size"],))}}
    for i in range(cfg["num_layers"]):
        att = {n: {"kernel": normal((d, heads, hd), d),
                   "bias": small((heads, hd))}
               for n, heads in (("query", h), ("key", kvh),
                                ("value", kvh))}
        att["out"] = {"kernel": normal((h, hd, d), d), "bias": small((d,))}
        tree[f"Block_{i}"] = {
            "LayerNorm_0": ln(), "LayerNorm_1": ln(),
            "SelfAttention_0": att,
            "Dense_0": {"kernel": normal((d, hid), d),
                        "bias": small((hid,))},
            "Dense_1": {"kernel": normal((hid, d), hid),
                        "bias": small((d,))}}
    return tree


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None,
                    help="also write the per-shape details here (JSON)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    root = Path(__file__).resolve().parent
    if not (root / "distkeras_tpu_torch" / "__init__.py").is_file():
        print("chip_smoke: distkeras_tpu_torch is not beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(root))
    from distkeras_tpu_torch import DecodeEngine, build_model, generate
    from distkeras_tpu_torch import convert
    from distkeras_tpu_torch.models import model_config
    from distkeras_tpu_torch.ops import _build, attention

    # full-f32 matmuls in the plain versions; no reduced-precision
    # split-K in bf16 products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    # ---- 1. build ---------------------------------------------------
    t0 = time.monotonic()
    libs = _build.build(["flash_attention_fwd", "flash_attention_bwd"])
    print(f"build: {time.monotonic() - t0:.1f} s")
    for name, so in libs.items():
        for line in so.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")
    card = _card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    # the serving path's requests, drawn first: their padded prompt
    # lengths are the forward kernel's shapes in phase 2
    rng = np.random.default_rng(args.seed)
    lengths = rng.integers(100, 1501, size=16)
    news = rng.integers(16, 65, size=16)
    reqs = [{"prompt": rng.integers(0, LM["vocab_size"], size=int(t)),
             "max_new_tokens": int(n), "i": i}
            for i, (t, n) in enumerate(zip(lengths, news))]
    hd = LM["d_model"] // LM["num_heads"]
    mix: dict = {}  # one launch per layer per admission at the padded length
    for t in lengths:
        key = (1, LM["num_heads"], -(-int(t) // 128) * 128, hd)
        mix[key] = mix.get(key, 0) + LM["num_layers"]

    # the training path launches each kernel once per layer per step at
    # [8, 12, 1024, 64]
    train_steps = TRAIN_EPOCHS * (TRAIN_ROWS // TRAIN["batch_size"])
    fwd_mix = dict(mix)
    fwd_mix[BWD_SHAPE] = (fwd_mix.get(BWD_SHAPE, 0)
                          + TRAIN_LM["num_layers"] * train_steps)

    # ---- 2. kernel vs plain ------------------------------------------
    check_shapes = [(1, 12, 128, 64), (1, 12, 640, 64), (1, 12, 2048, 64),
                    (8, 12, 512, 64), (2, 4, 200, 128)]
    rows = _check_attention(attention, torch, check_shapes)
    rows += _check_attention(attention, torch, sorted(fwd_mix))
    max_err = max(r["max_abs_err"] for r in rows
                  if r["dtype"] == "bfloat16")
    timing = _time_attention(attention, torch, F, sorted(fwd_mix))
    bwd_rows = _check_attention_bwd(
        attention, torch,
        [BWD_SHAPE, (1, 12, 128, 64), (8, 12, 512, 64), (2, 4, 200, 128)])
    bwd_timing, bwd_whole = _time_attention_bwd(attention, torch, F,
                                                BWD_SHAPE)

    # ---- 3. serving path --------------------------------------------
    cfg = model_config("transformer_lm", (LM["max_len"],),
                       input_dtype="int32", **LM)
    t0 = time.monotonic()
    model = build_model(cfg).eval()
    model.load_state_dict(convert.params_from_flax(
        _flax_tree(np.random.default_rng(args.seed + 1), LM)))
    print(f"model: {sum(p.numel() for p in model.parameters())} params, "
          f"built in {time.monotonic() - t0:.1f} s")
    engine = DecodeEngine(model, slots=8, buckets=[512, 2048],
                          prefill_align=128)
    # warm the caching allocator and cuBLAS on a throwaway request
    list(engine.run([{"prompt": reqs[0]["prompt"], "max_new_tokens": 2}]))
    torch.cuda.synchronize()
    _reset_counts(attention)
    t0 = time.monotonic()
    results = list(engine.run(reqs))
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    serve_counts = _counts(attention)
    launches = serve_counts["flash_attention_fwd"]
    engine.close()
    n_tok = sum(len(r["tokens"]) for r in results)
    ttft = np.percentile([r["ttft"] for r in results], [50, 95])
    print(f"serve: requests={len(results)} tokens={n_tok} "
          f"tokens_per_s={n_tok / wall:.1f} wall_s={wall:.3f} "
          f"ttft_p50_s={ttft[0]:.4f} ttft_p95_s={ttft[1]:.4f}")
    if launches != 12 * len(reqs):
        raise SystemExit(f"flash kernel launched {launches} times on the "
                         f"serving path; expected {12 * len(reqs)}")
    if serve_counts["flash_attention_bwd_dq"] \
            or serve_counts["flash_attention_bwd_dkv"]:
        raise SystemExit(f"serving launched a backward kernel: "
                         f"{serve_counts}")
    mismatched = []
    for r in results:
        p = r["prompt"]
        if "error" in r:
            raise SystemExit(f"request {r['i']} failed: {r['error']}")
        n = reqs[r["i"]]["max_new_tokens"]
        want = generate(model, p[None], max_new_tokens=n)[0, len(p):]
        want = want.cpu().numpy()
        got = r["tokens"]
        if len(got) != n or not ((got >= 0) & (got < LM["vocab_size"])).all():
            raise SystemExit(f"request {r['i']}: bad tokens {got}")
        if not np.array_equal(got, want):
            first = int(np.argmax(got != want))
            mismatched.append((r["i"], len(p), first, len(got)))
    if mismatched:
        raise SystemExit(f"engine tokens differ from generate() "
                         f"(request, prompt len, first diff, n): "
                         f"{mismatched}")
    print("parity: engine tokens == generate() for all 16 requests")
    # the same traffic once more, under the profiler: where the time goes
    prof = _profile_serve(DecodeEngine(model, slots=8, buckets=[512, 2048],
                                       prefill_align=128), reqs, torch)
    # device time is the same traffic's in both runs; the profiled
    # run's own wall carries the profiler's host cost, so divide by the
    # unprofiled wall
    prof["idle_share"] = 1.0 - prof["device_busy_ms"] / 1e3 / wall
    print(f"profile: device idle share of the serving wall "
          f"{prof['idle_share']:.4f}")

    del model
    torch.cuda.empty_cache()

    # ---- 4. training path -------------------------------------------
    train, train_counts = _train(args.seed, torch, np)

    # ---- 5. kernel table ---------------------------------------------
    # the forward kernel's numbers are launch-weighted over both paths'
    # shapes (phase 4 checked the training path's counts); the backward
    # kernels run on the training path only
    total = sum(fwd_mix.values())

    def mean(field):
        return sum(fwd_mix[s] * timing[s][field] for s in fwd_mix) / total

    by_ops = sum(n for s, n in fwd_mix.items()
                 if timing[s]["bound_by"] == "operations")
    by_path = {k: {"serve": serve_counts[k], "train": train_counts[k]}
               for k in train_counts}
    kernels = [{"name": "flash_attention_fwd", "route": "cuda",
                "source": "distkeras_tpu_torch/csrc/flash_attention_fwd.cu",
                "replaces": "distkeras_tpu/ops/attention.py:76",
                "launches": launches + train_counts["flash_attention_fwd"],
                "launches_by_path": by_path["flash_attention_fwd"],
                "max_abs_err": max_err, "max_err": max_err,
                "ms": mean("ms"), "plain_ms": mean("plain_ms"),
                "bound_ms": mean("bound_ms"),
                "bound_by": "operations" if 2 * by_ops >= total else "bytes",
                "library_ms": mean("library_ms")}]
    for name, out, replaces in (
            ("flash_attention_bwd_dq", ("dq",),
             "distkeras_tpu/ops/attention.py:117"),
            ("flash_attention_bwd_dkv", ("dk", "dv"),
             "distkeras_tpu/ops/attention.py:152")):
        err = max(r[f"{o}_err"] for r in bwd_rows for o in out
                  if r["dtype"] == "bfloat16")
        kernels.append({
            "name": name, "route": "cuda",
            "source": "distkeras_tpu_torch/csrc/flash_attention_bwd.cu",
            "replaces": replaces, "launches": train_counts[name],
            "launches_by_path": by_path[name], "max_abs_err": err,
            **bwd_timing[name]})
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({
            "card": card, "checks": rows, "bwd_checks": bwd_rows,
            "timing": [{"shape": list(s), "launches_per_run": fwd_mix[s],
                        **timing[s]} for s in sorted(fwd_mix)],
            "bwd_timing": {**bwd_timing, "whole_backward": bwd_whole,
                           "shape": list(BWD_SHAPE)},
            "serve": {"requests": len(results), "tokens": n_tok,
                      "wall_s": wall, "tokens_per_s": n_tok / wall,
                      "ttft_p50_s": ttft[0], "ttft_p95_s": ttft[1]},
            "profile": prof, "train": train,
            "kernels": kernels}, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0

if __name__ == "__main__":
    sys.exit(main())
