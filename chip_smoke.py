#!/usr/bin/env python3
"""Chip smoke of distkeras_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py [--out PATH]

Phases, in order; any failure exits nonzero and prints no result:

1. build every CUDA kernel of the serving, LM training, PS training,
   fused ResNet and sequence-parallel paths from ``csrc/`` (one ``nvcc``
   per source, all started together), print the card's name and power
   limit, and read each flash forward and backward kernel's registers
   and spill bytes per instantiation from the compiler's report, and
   those of the fused bf16 kernels' product body;
2. hold each kernel against its plain PyTorch version on the card at
   the paths' shapes (and a few more: the flash backward also at
   [8, 12, 1024, 128] bf16 causal, where its registers bind), with the
   tolerances below, and time kernel, plain version and the one
   PyTorch call that computes the same function (``library_ms``, timed
   here and used nowhere in the port), with each flash kernel's
   achieved TFLOP/s;
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
5. the PS training path: (a) hold both GroupNorm kernels against their
   plain versions at every [B, HW, C, G] of ResNet-50's path and
   ``GN_EXTRA_SHAPES`` (bf16 and f32, ReLU on and off, on the planned
   route and, where that is one pass, on the two-pass route; the bf16
   path shapes run twice and must be bit-equal; ``TOL_GN*``), (b) time
   each per launch against its byte bound, its plain version and
   ``F.group_norm``, with each shape's plan (channel splits, cluster
   size, shared memory, clusters the card holds at once) and the
   two-pass route and the neighbouring cluster size beside it, (c) compare
   step 1's gradients of ``norm="group_pallas"`` with ``norm="group"``
   (``TOL_GN_GNORM``/``TOL_GN_GRAD``), (d) train ResNet-50-GroupNorm
   (``scripts/perf_ps_flagship.py``'s model and round, not cut: 224 px,
   s2d stem, bf16, 4 workers, window 2, batch 32) through
   ``ADAG(fidelity="faithful")`` for 2 epochs of 4 rounds: 53
   GroupNorms per step, so exactly 424 launches of each kernel per
   round, all on the one-pass route, finite and falling losses, each round's staleness a
   permutation of 0..3, PS clock 4 x rounds; (e) one epoch of
   ``AEASGD`` (the elastic rule) at smaller depth; (f) the trainer's
   round time (its second epoch's wall over its rounds), step time,
   images/s, MFU by analytic conv FLOPs, and one round of the trainer
   under ``torch.profiler``: idle share and device time by class;
6. the fused ResNet path: (a) hold the four fused-block kernels against
   their plain versions at every call shape of ResNet-50's
   ``fusion="pallas_block"`` path at batch 256 (12 fused-conv and 4 tail
   shapes, bf16 and f32; ``TOL_FB*``; the bf16 kernels run twice and
   must be bit-equal), (a') the bf16 forwards under both pass plans at
   one shape per stage must be bit-equal, (b) time each per launch
   against its bound, its plain version and the torch spelling of the
   same region as ``fusion="none"`` runs it, with each bf16 kernel's
   device time by grid and #7, #8 and #9 also under the pass plan their
   rules did not choose, (c) train ``scripts/perf_fused_e2e.py``'s
   configuration (ResNet-50, 224 px, s2d stem, bf16, momentum at lr 0.1,
   batch 256) through ``SingleTrainer`` for 2 epochs of 4 steps: exactly
   20/20/16/16 launches of the four kernels per step, finite losses, the
   epoch loss falling; the same from the same weights with ``fusion=
   "none"``; two runs of two steps with bit-equal losses; both step times
   in turns; two fused steps under ``torch.profiler``, (d) two steps of
   ``fusion="pallas_tail", fusion_stages=(0, 1)`` at stages 1-1-1-1,
   (e) step 1's gradients of ``pallas_block`` against ``fusion="none"``
   at batch 32 (``TOL_GN_GNORM``/``TOL_GN_GRAD``);
7. the sequence-parallel LM path (ring attention over an in-process
   ring of 4 ranks run in turn on the card, every hop through kernels
   #3-#4): (a) hold the three hop kernels against their plain versions
   at the path's [4, 12, 2048, 64] (bf16 and f32; diagonal, past and
   dead hops; one hop without the mask; one at D 128), a dead hop
   passing the state bit for bit, (b) time each per launch by hop kind
   against its bound, its plain version and SDPA's flash kernel (and
   its backward) on the same block, (c) train the JAX package's
   long-context configuration (L12, d768, 12 heads, vocab 32768, T
   8192, batch 4, bf16, adam 3e-4) with ``seq_axis="seq"`` and
   ``ring_attn_fn("seq", impl="flash")`` for 2 epochs of 4 steps
   through ``make_train_step``: exactly 192 launches of each hop kernel
   per step, none of kernels #1-#2, finite and falling losses, (d) the
   ``flash_attn=True`` twin from the same start: first 3 losses and
   step 1's gradients within ``TOL_TRAIN_*``, (e) step 1's gradients of
   the ring against dense attention at T 2048, (f) two runs of two
   steps with bit-equal losses, (g) step time, tokens/s, MFU and two
   steps under ``torch.profiler``;
8. the rest of the Trainer family: (a) ``SyncTrainer`` (4 workers of
   64 rows) trains phase 6's fused ResNet-50 for 2 epochs of 2 steps in
   turns with ``SingleTrainer`` at batch 256 from the same weights:
   exactly 20/20/16/16 launches of #7-#10 a step, finite losses bit-equal
   to SingleTrainer's in every turn, both trainers' time a step; (b)
   ``AveragingTrainer`` (2 members of batch 32, 2 steps each) on phase
   5's ``norm="group_pallas"`` ResNet-50: exactly 53 launches of each
   GroupNorm kernel a member step, all one-pass, the result the
   members' mean; one step of ``EnsembleTrainer``'s 2 members, which
   differ; (c) ``ADAG(fidelity="faithful")`` over ResNet-50 with
   ``norm="batch"``, 2 workers, window 2, batch 32, 2 rounds: finite
   losses, each worker's BatchNorm statistics moved and apart from the
   other's, the returned ones worker 0's, the round time; (d) the MNIST
   MLP at ``dropout_rate=0.3`` through ``EnsembleTrainer``: the members
   draw different masks, a rerun is bit-equal;
9. checkpoints, kill-and-resume, evaluation and prediction at full
   width, in a temporary directory removed at the end: (a) ADAG
   (faithful) over phase 5's ResNet-50 (``norm="group_pallas"``, #5-#6),
   2 workers, window 2, batch 32, 384 rows (3 rounds an epoch), 2
   epochs, ``checkpoint_every_rounds=2``: the uninterrupted run, a run
   stopped right after the save at round 2 of the second epoch, and a
   resume from it, whose center, worker 0's model state and history
   (``round_loss``, ``epoch_loss``, ``dropped_tail_batches``,
   ``staleness``, ``eval_accuracy``) must equal the uninterrupted run's
   bit for bit; (b) the same for ``SingleTrainer`` on phase 6's fused
   path (#7-#10), 2 epochs of 2 steps, stopped after epoch 1; both with
   ``eval_dataset`` (300 rows): one ``eval_accuracy`` an epoch; (c)
   ``ModelPredictor`` scores the 300 rows at batch 256 (a ragged tail)
   through #7 and #9, its logits held against the plain versions'
   forward on the same model (``TOL_PREDICT``); on the rows relabelled
   with the plain forward's classes, ``evaluate_model``,
   ``AccuracyEvaluator`` and a numpy argmax must agree, at an accuracy
   of at least ``EVAL_AGREE``; (d) every saved
   file read back bit-equal to its state, ``serialize_params`` and a PS
   snapshot round-tripped; the launch counts of each path, the bytes
   and seconds of each save and load, and the predictor's images/s;
10. the host-wire parameter server: phase 5's model and round
   (ResNet-50, ``norm="group_pallas"``, ADAG at ``lr_law="scale"``,
   window 2, batch 32, ``imagenet_synth`` rows) through
   ``ADAG(fidelity="host")``: worker threads on the card, the server in
   host memory: (a) ``transport="socket"``, 4 worker threads, 2 epochs:
   finite losses, the server's clock equal to the commits made, every
   staleness >= 0, exactly 53 launches of #5 and of #6 per worker step
   counted across the threads, all one-pass; (b) one worker: ``socket``,
   ``inprocess`` and ``fidelity="faithful"`` from one start must give
   bit-equal results and losses; (c) ``compression="int8"``: the wire's
   bytes against the raw f32 bytes near 1/4 (``HOST_INT8_RATIO``),
   finite losses; (d) ``ps_shards=2`` over ``socket``: the clock as in
   (a), the version-delta pull savings; (e) ``ChaosTransport`` resets and
   truncations under ``worker_retries``: the run completes with every
   commit applied once (the server's applied commits against those
   sent, duplicates answered from the reply cache), and the snapshot
   written after the last commit, restarted by ``PSServer.restart_from``,
   holds the server's state bit for bit; (f) report, with no limits: one
   commit's round trip over loopback TCP with the 102 MB center, the
   host arm's round time beside phase 5's emulated round, and the
   device's idle share over an epoch under ``torch.profiler``;
11. out-of-core data and the baseline families, in a temporary directory
   removed at the end: (a) phase 5's model and round (ResNet-50,
   ``norm="group_pallas"``, faithful ADAG at ``lr_law="scale"``, 4
   workers, window 2, batch 32) over ``imagenet_synth`` rows written as
   npz shards (4 of 256 rows and a runt of 100): one shard against the
   same rows in memory from one start, bit-equal results and round
   losses; the 4 shards and the runt for one epoch with
   ``DKT_SEGMENT_PREFETCH`` 1 against 0, bit-equal, the runt's 100 rows
   in ``skipped_segment_rows``, each run's ``segment_stall_s``; the same
   shards through ``fidelity="host"``, ``transport="inprocess"``, 2
   workers, the server's clock equal to the commits made; in every run
   exactly 53 launches of #5 and of #6 a worker step, all one-pass; (b)
   BASELINE row 5: ``criteo_synth`` at its published widths (13 dense,
   26 categorical) written as 8 CSV shards of 32,768 rows and a held-out
   one; the C and Python parse lanes equal column for column on one
   shard (MB/s of each); ``from_csv_shards(...).map(pipeline)`` with the
   pipeline (assemble the dense columns, ``MinMaxTransformer``, 26
   ``HashBucketTransformer``s of 10,000 buckets, ``AssembleTransformer``)
   fitted on shard 0; ``wide_deep`` at its module defaults through
   DOWNPOUR (4 workers, window 2, batch 512, adam 1e-3) for 2 epochs:
   every shard parsed, scaled and bucketed by the native library's C
   lane (its call counters exactly), the epoch loss falling, and
   ``ModelPredictor`` with ``AccuracyEvaluator`` on the held-out shard
   above 0.6; ETL rows/s, ``segment_stall_s`` and the round time; (c)
   BASELINE row 4: ``bilstm`` at its module defaults (vocab 20,000,
   embed and hidden 128) on ``imdb_synth(16384, seq_len=256)``: the
   cuDNN recurrence against the plain time loop on one batch (f32, one
   row with a 0 inside), logits and gradients within ``TOL_LSTM`` of
   their rms; DynSGD (4 workers, window 2, batch 64, adam 1e-3) for 2
   epochs, finite and falling losses, every recurrence on cuDNN; the
   round time and tokens/s;
12. the serving arms on phase 3's model and weights: (a) phase 3's
   traffic on ``kv_cache_dtype="int8"``: tokens equal int8
   ``generate()``, 12 launches of #1 per admission, the KV pools' bytes
   against bf16's; (b) the same traffic paged (``kv_pages=256``,
   ``page_size=128``): tokens equal phase 3's bit for bit, each step's
   time against the envelope engine's; a swap-preemption drill on a
   20-page pool with two priorities token-equal to the envelope engine,
   a ``"recompute"`` drill that finishes every request with its
   re-prefills on #1, both page ledgers balanced; (c) 16 chat requests
   sharing a 1024-token system prompt: exactly 15 hits and 15 x 1024
   tokens saved, 12 launches with the store on, TTFT p50/p95 on and off,
   a hit's first-token logits within ``TOL_PREFIX_LOGITS`` of the whole
   prefill's, f32 hits token-equal; one 2040-token prompt in chunks of
   256 beside live decodes that gain tokens between its chunks; (d)
   speculation on prompts repeating a 64-token motif (n-gram, the model
   as its own draft, a 2-layer draft): accept rates and tokens/s, the
   f32 self-draft accepting every proposal; (e) a prefix exported,
   packed, unpacked and imported into a second engine gives the
   monolithic engine's tokens; a swap mid-run adds no program key and
   empties the store; (f) the telemetry's token and prefix counters
   equal the results.  bf16 paths that read one attention two ways are
   held by ``DIVERGE_MARGIN``; #1 is held against its plain version at
   the phase's new shapes;
13. print the kernel table as one JSON line, then the device line last.

Exits nonzero without a CUDA device, and where the package is missing
beside this file.  ``--out`` also writes the per-shape details as JSON.
"""

from __future__ import annotations

import argparse
import json
import re
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
# the same at head size 128, where the bf16 backward kernels' registers
# bind (two D-wide f32 accumulators in the dk/dv kernel): checked bf16
# causal and timed beside the path's shape
BWD_SHAPE_D128 = (8, 12, 1024, 128)


def _card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def _ptxas_report(text: str) -> dict:
    """Registers and spill bytes of each function in an ``nvcc -Xptxas
    -v`` report: ``{mangled name: {"registers": n, "spill_stores": n,
    "spill_loads": n}}``, and ``"smem"`` where the report gives static
    shared memory."""
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )([^' ]+)", line)
        if m:
            name = m.group(1)
            out.setdefault(name, {})
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[name].update(spill_stores=int(m.group(1)),
                             spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m:
            out[name]["smem"] = int(m.group(1))
    return out


def _kernel_resources(text: str, kernel: str) -> dict:
    """The ptxas report of each instantiation of the kernel template
    named ``kernel`` (unqualified): a flash kernel ``<T, D>`` keyed
    ``bf16_d64``, ``f32_d128``...; the fused block's product body
    ``gemm_kernel<BN, NWG, A_MN, B_MN, Epi>`` keyed by its epilogue, BN
    and NWG: ``StatsEpi_n128_w2``..."""
    flash = re.compile(rf"{len(kernel)}{kernel}I(13__nv_bfloat16|f)Li(\d+)E")
    body = re.compile(rf"{len(kernel)}{kernel}ILi(\d+)ELi(\d+)ELb[01]ELb[01]E"
                      rf"NS0_(\d+)")
    res = {}
    for name, info in _ptxas_report(text).items():
        m = flash.search(name)
        if m:
            dtype = "f32" if m.group(1) == "f" else "bf16"
            res[f"{dtype}_d{m.group(2)}"] = info
            continue
        m = body.search(name)
        if m:
            epi = name[m.end():m.end() + int(m.group(3))]
            res[f"{epi}_n{m.group(1)}_w{m.group(2)}"] = info
    return dict(sorted(res.items()))


# kernel table name -> (library, kernel template) of the ptxas report
# written beside the kernels' entries
PTXAS_ROWS = {"flash_attention_fwd": ("flash_attention_fwd", "fwd_kernel"),
              "flash_attention_bwd_dq": ("flash_attention_bwd", "dq_kernel"),
              "flash_attention_bwd_dkv": ("flash_attention_bwd",
                                          "dkv_kernel"),
              "flash_hop_fwd": ("flash_hop", "hop_fwd_kernel"),
              "flash_hop_bwd_dq": ("flash_hop", "hop_dq_kernel"),
              "flash_hop_bwd_dkv": ("flash_hop", "hop_dkv_kernel"),
              "conv1x1_gn_fwd": ("fused_block", "gemm_kernel"),
              "conv1x1_gn_bwd": ("fused_block", "gemm_kernel"),
              "bottleneck_tail_fwd": ("fused_block", "gemm_kernel"),
              "bottleneck_tail_bwd": ("fused_block", "gemm_kernel")}
# the product body's epilogues each bf16 fused kernel runs (the first
# field of _kernel_resources's keys)
PTXAS_EPILOGUES = {"conv1x1_gn_fwd": ("StatsEpi", "ApplyEpi"),
                   "conv1x1_gn_bwd": ("StatsEpi", "BwdStatsEpi",
                                      "BwdApplyEpi", "StoreEpi", "ChunkEpi"),
                   "bottleneck_tail_fwd": ("StatsEpi", "ApplyEpi"),
                   "bottleneck_tail_bwd": ("StatsEpi", "BwdStatsEpi",
                                           "BwdApplyEpi", "DhEpi",
                                           "ChunkEpi")}


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


def _attn_flops(b, h, t, d, causal):
    """Operations of the forward's two T x T x D products per head;
    causal work counts the causal half."""
    return 4 * b * h * t * t * d * (0.5 if causal else 1.0)


def _attn_bound(b, h, t, d, dtype, causal):
    """Least time (ms) and what bounds it: q, k, v read once, out and
    lse written once; causal work counts the causal half."""
    item = 2 if dtype == "bfloat16" else 4
    flops = _attn_flops(b, h, t, d, causal)
    nbytes = 4 * b * h * t * d * item + b * h * t * 4
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _bwd_flops(b, h, t, d, causal, products):
    """Operations of ``products`` T x T x D products per head; causal
    work counts the causal half."""
    return 2 * products * b * h * t * t * d * (0.5 if causal else 1.0)


def _tflops(flops, ms):
    """Achieved TFLOP/s of ``flops`` operations in ``ms``."""
    return flops / (ms * 1e-3) / 1e12 if ms > 0 else 0.0


def _bwd_bound(b, h, t, d, dtype, causal, products, outputs):
    """Least time (ms) and what bounds it for a backward function that
    does ``products`` T x T x D products per head and writes
    ``outputs`` [B, H, T, D] tensors: q, k, v, do read once, lse and
    dsum read once, the outputs written once; causal work counts the
    causal half."""
    item = 2 if dtype == "bfloat16" else 4
    flops = _bwd_flops(b, h, t, d, causal, products)
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


def _check_attention_bwd(attention, torch, shapes, extra=()):
    """Backward kernels vs their plain versions on the card: every shape
    in bf16 and f32, causal or not, then the ``extra`` (shape, dtype,
    causal) cases."""
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(2)
    cases = [(shape, dname, causal) for shape in shapes
             for dname in ("bfloat16", "float32")
             for causal in (True, False)] + list(extra)
    for shape, dname, causal in cases:
        q, k, v, do, lse, dsum, scale = _bwd_case(
            attention, torch, gen, shape, getattr(torch, dname), causal)
        kw = dict(scale=scale, causal=causal)
        got = (attention.flash_attention_bwd_dq(q, k, v, do, lse, dsum, **kw),
               *attention.flash_attention_bwd_dkv(q, k, v, do, lse, dsum,
                                                  **kw))
        want = (attention.flash_attention_bwd_dq_reference(
            q, k, v, do, lse, dsum, **kw),
            *attention.flash_attention_bwd_dkv_reference(
                q, k, v, do, lse, dsum, **kw))
        torch.cuda.synchronize()
        row = {"shape": list(shape), "dtype": dname, "causal": causal}
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
            raise SystemExit(f"flash_attention_bwd disagrees with its plain "
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
        tflops = _tflops(_bwd_flops(*shape, True, BWD_WORK[name][0]), ms)
        out[name] = {"ms": ms, "plain_ms": plain_ms, "library_ms": library,
                     "bound_ms": bound, "bound_by": by, "tflops": tflops}
        print(f"timing {name} {list(shape)} bf16 causal: kernel {ms:.4f} "
              f"ms ({tflops:.1f} TFLOP/s), plain {plain_ms:.4f} ms, sdpa "
              f"backward {library:.4f} ms "
              f"({_tflops(_bwd_flops(*shape, True, 5), library):.1f} "
              f"TFLOP/s), bound {bound:.5f} ms ({by})")
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
        flops = _attn_flops(b, h, t, d, True)
        out[(b, h, t, d)] = {"ms": ms, "plain_ms": plain,
                             "library_ms": lib, "bound_ms": bound,
                             "bound_by": by, "tflops": _tflops(flops, ms)}
        print(f"timing [{b},{h},{t},{d}] bf16 causal: kernel {ms:.4f} ms "
              f"({_tflops(flops, ms):.1f} TFLOP/s), plain {plain:.4f} ms, "
              f"sdpa {lib:.4f} ms ({_tflops(flops, lib):.1f} TFLOP/s), "
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


# the port's profiler ranges (``record_function``): their device-side
# spans overlap the kernels inside them, so they are no kernels
RANGES = ("optimizer_update", "ps_commits")


def _device_kernels(prof, torch):
    kernels = {}
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA \
                and not getattr(ev, "is_user_annotation", False) \
                and ev.key not in RANGES:
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


def _first_grads_agree(flash, dense, start, batch, loss, torch,
                       what="flash against dense"):
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
            raise SystemExit(f"step 1 gradient of {name}: {what} "
                             f"relative error {err:.4g}")
    print(f"train: step 1 gradients {what}, largest relative "
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


# ---- phase 5: the PS training path (ResNet-50-GroupNorm, ADAG) -------

# scripts/perf_ps_flagship.py's model and round, not cut: ResNet-50 on
# 224 px ImageNet-shaped input, s2d stem, bf16 compute, f32 masters, 4
# workers, window 2, batch 32, momentum SGD.  Two settings differ from
# that script's defaults (norm="group", --lr 0.1 with no lr law):
# norm="group_pallas" puts GroupNorm on the hand-written kernels, and
# the rate is 0.05 divided by ADAG's measured law (lr_law="scale": lr /
# num_workers) to 0.0125
RESNET = dict(num_classes=1000, stage_sizes=(3, 4, 6, 3), bottleneck=True,
              stem="space_to_depth", norm="group_pallas")
IMAGE = 224
PS = dict(num_workers=4, communication_window=2, batch_size=32,
          worker_optimizer="momentum", fidelity="faithful",
          loss="sparse_categorical_crossentropy")
PS_LR = 0.05
PS_ROWS, PS_EPOCHS = 1024, 2       # 4 rounds of 4 x 2 x 32 images per epoch
AEASGD_STAGES, AEASGD_ROWS = (1, 1, 1, 1), 512
# GroupNorm kernels against their plain versions, per element scaled by
# |plain| + rms(plain), as the flash backward is held: f32 differs by
# summation order only (mean and inv-std to ~1e-6 relative, carried
# through the affine and the backward's group terms); bf16 may round an
# element to the neighbouring value: one bf16 ulp of |y| (2^-7)
TOL_GN = {"bfloat16": 2 ** -7, "float32": 1e-4}
# mean: a sum of up to 25,088 f32 terms of size ~2 in another order
# (absolute); inv-std: the same for E[x^2], then rsqrt (relative);
# dgamma, dbeta per image: sums over HW in another order (per element,
# scaled as above)
TOL_GN_MEAN, TOL_GN_INV, TOL_GN_PARAM = 1e-5, 1e-5, 1e-4
# step 1's gradients, norm="group_pallas" against norm="group" from the
# same start on the same batch, in f32 (cuDNN without TF32): the global
# norm within 1e-2 and each parameter within 5e-2 in norm, both
# relative (floor: 1e-3 of the whole gradient's norm); the two differ by
# summation order only (5e-5 on the CPU at 16 blocks).  In bf16 only the
# global norm is held (1e-2): F.group_norm takes gamma in bf16 and both
# sides round every activation and gradient to bf16 in their own way,
# which moves the gradients of the first layers, sums with much
# cancellation, by tens of percent against f32 on either side (the CPU
# at 16 blocks); those numbers are printed, each side against f32
TOL_GN_GNORM, TOL_GN_GRAD = 1e-2, 5e-2


# [B, HW, C, G] beside the path's: the cuda tests' GN_SHAPES (the stem's
# narrow groups at batch 4, a wide late stage at batch 3, an odd row
# count, and channels off the 16-byte vector: the two-pass route's
# one-element path)
GN_EXTRA_SHAPES = ((4, 12544, 64, 32), (3, 49, 2048, 32), (2, 37, 96, 8),
                   (2, 25, 12, 4))
# the GroupNorm kernels of each direction (ptxas rows and profiler
# classes): the one-pass cluster kernel, then the two-pass route's grids
GN_KERNELS = {"group_norm_fwd": ("fwd_cluster_kernel", "fwd_stats_kernel",
                                 "fwd_fold_kernel", "fwd_apply_kernel"),
              "group_norm_bwd": ("bwd_cluster_kernel", "bwd_stats_kernel",
                                 "bwd_fold_kernel", "bwd_apply_kernel")}


def _gn_counts(gn):
    return {"group_norm_fwd": gn.fwd_launches,
            "group_norm_bwd": gn.bwd_launches}


def _reset_gn(gn):
    gn.fwd_launches = gn.bwd_launches = gn.gradient_copies = 0
    for key in gn.route_launches:
        gn.route_launches[key] = 0


def _gn_resources(text: str, kernels) -> dict:
    """The ptxas report of each GroupNorm kernel: a template ``<T, V>``
    keyed ``fwd_cluster_kernel_bf16_v8``..., a fold kernel by its name."""
    report = _ptxas_report(text)
    res = {}
    for name in kernels:
        for key, info in _kernel_resources(text, name).items():
            res[f"{name}_{key.replace('_d', '_v')}"] = info
        for mangled, info in report.items():
            if f"{len(name)}{name}E" in mangled:
                res[name] = info
    return dict(sorted(res.items()))


def _resnet_shapes(model, batch, torch):
    """One forward at ``batch`` with hooks: the GroupNorm calls as
    ``{(B, HW, C, G, relu): count}`` and the analytic forward FLOPs of
    one image (2 per multiply-add of every conv and of the head)."""
    from distkeras_tpu_torch.models.layers import Conv, Dense
    from distkeras_tpu_torch.models.resnet import AdaptiveGroupNorm

    mix, flops, hooks = {}, [0.0], []

    def on_norm(mod, inp, out):
        x = inp[0]
        key = (x.shape[0], x.shape[2] * x.shape[3], x.shape[1], mod.groups,
               mod.relu)
        mix[key] = mix.get(key, 0) + 1

    def on_conv(mod, inp, out):
        flops[0] += (2.0 * out.shape[1] * out.shape[2] * out.shape[3]
                     * mod.weight[0].numel())

    def on_dense(mod, inp, out):
        flops[0] += 2.0 * mod.weight.numel()

    for m in model.modules():
        if isinstance(m, AdaptiveGroupNorm):
            hooks.append(m.register_forward_hook(on_norm))
        elif isinstance(m, Conv):
            hooks.append(m.register_forward_hook(on_conv))
        elif isinstance(m, Dense):
            hooks.append(m.register_forward_hook(on_dense))
    with torch.no_grad():
        model(torch.zeros(batch, IMAGE, IMAGE, 3, device="cuda"))
    for h in hooks:
        h.remove()
    return mix, flops[0]


def _gn_case(gn, torch, gen, key, dtype):
    b, hw, c, g, _ = key
    x = (torch.randn(b, hw, c, device="cuda", generator=gen) * 2 + 0.5
         ).to(dtype)
    dy = torch.randn(b, hw, c, device="cuda", generator=gen).to(dtype)
    gamma = torch.randn(c, device="cuda", generator=gen) * 0.5 + 1
    beta = torch.randn(c, device="cuda", generator=gen) * 0.1
    return x, dy, gamma, beta


def _ratio(a, b):
    a, b = a.float(), b.float()
    rms = b.square().mean().sqrt()
    return ((a - b).abs() / (b.abs() + rms)).max().item()


def _gn_row(torch, key, dname, relu, route, got, want):
    """One kernel call's outputs against the plain versions', held to
    ``TOL_GN*``."""
    (y, mean, inv, dx, dg, db), (ry, rmean, rinv, rdx, rdg, rdb) = got, want
    row = {"shape": list(key), "dtype": dname, "relu": relu, "route": route,
           "y_err": (y.float() - ry.float()).abs().max().item(),
           "dx_err": (dx.float() - rdx.float()).abs().max().item(),
           "y_ratio": _ratio(y, ry), "dx_ratio": _ratio(dx, rdx),
           "mean_err": (mean - rmean).abs().max().item(),
           "inv_rel_err": ((inv - rinv).abs() / rinv).max().item(),
           "dgamma_ratio": _ratio(dg, rdg), "dbeta_ratio": _ratio(db, rdb)}
    row["ok"] = (row["y_ratio"] <= TOL_GN[dname]
                 and row["dx_ratio"] <= TOL_GN[dname]
                 and row["mean_err"] <= TOL_GN_MEAN
                 and row["inv_rel_err"] <= TOL_GN_INV
                 and row["dgamma_ratio"] <= TOL_GN_PARAM
                 and row["dbeta_ratio"] <= TOL_GN_PARAM
                 and bool(torch.isfinite(y).all())
                 and bool(torch.isfinite(dx).all()))
    print(f"group_norm {row}")
    if not row["ok"]:
        raise SystemExit(f"the GroupNorm kernels disagree with their plain "
                         f"versions: {row}")
    return row


def _check_group_norm(gn, torch, shapes, reruns=()):
    """(a) Both kernels against their plain versions at every [B, HW, C,
    G] in ``shapes``, bf16 and f32, ReLU on and off, on the route
    ``launch_plan`` chooses and, where that is the one-pass route, on
    the two-pass route too; in bf16 at the shapes in ``reruns`` the chosen
    route runs twice and must give bit-equal outputs."""
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(5)
    for key in shapes:
        b, hw, c, g = key
        for dname in ("bfloat16", "float32"):
            for relu in (False, True):
                x, dy, gamma, beta = _gn_case(
                    gn, torch, gen, (b, hw, c, g, relu),
                    getattr(torch, dname))
                kw = dict(groups=g, relu=relu)
                ry, rmean, rinv = gn.group_norm_fwd_reference(x, gamma,
                                                              beta, **kw)
                # both backwards from the same statistics: the same
                # x-hat, so the same ReLU mask
                want = (ry, rmean, rinv, *gn.group_norm_bwd_reference(
                    x, dy, gamma, beta, rmean, rinv, **kw))
                plan = "/".join(gn.launch_plan(b, hw, c, g, x.dtype, d,
                                               "cuda").route
                                for d in ("fwd", "bwd"))
                routes = [None] + (["two_pass"] if "one_pass" in plan
                                   else [])

                def run(route):
                    y, mean, inv = gn._fwd_kernel(x, gamma, beta, eps=1e-6,
                                                  route=route, **kw)
                    return (y, mean, inv, *gn._bwd_kernel(
                        x, dy, gamma, beta, rmean, rinv, route=route, **kw))

                for route in routes:
                    got = run(route)
                    torch.cuda.synchronize()
                    row = _gn_row(torch, key, dname, relu,
                                  plan if route is None
                                  else "two_pass/two_pass", got, want)
                    if dname == "bfloat16" and key in reruns \
                            and route is None:
                        again = run(route)
                        torch.cuda.synchronize()
                        row["rerun_bit_equal"] = all(
                            torch.equal(a, b) for a, b in zip(got, again))
                        if not row["rerun_bit_equal"]:
                            raise SystemExit(f"a bf16 GroupNorm rerun "
                                             f"differs: {row}")
                    rows.append(row)
    return rows


def _gn_bound(b, hw, c, g, dtype, backward):
    """Least time (ms) of one launch, each input read once and each
    output written once.  Forward: x and the f32 gamma, beta [C] read; y
    and the f32 mean, inv-std [B, G] written.  Backward: x, dy, gamma,
    beta, mean and inv-std read; dx and the f32 per-image dgamma, dbeta
    [B, C] written.  A few operations per element, so bytes bound."""
    item = 2 if dtype == "bfloat16" else 4
    nbytes = ((3 if backward else 2) * b * hw * c * item
              + 4 * (2 * c + 2 * b * g + (2 * b * c if backward else 0)))
    return nbytes / PEAK_BYTES * 1e3


def _gn_route(gn, b, hw, c, g, direction):
    """The chosen route of a bf16 call and what the card makes of it:
    cluster size, rows a block, shared memory a block as planned and as
    the source computes it for the launch, and the clusters the card
    holds at once (``cudaOccupancyMaxActiveClusters``)."""
    import torch

    plan = gn.launch_plan(b, hw, c, g, torch.bfloat16, direction, "cuda")
    out = {"route": plan.route, "k": plan.k, "splits": plan.splits,
           "rows": plan.rows, "smem": plan.smem}
    if plan.route == "one_pass":
        smem, clusters = gn.one_pass_launch(plan, b, hw, c, g,
                                            torch.bfloat16, direction)
        if smem != plan.smem:
            raise SystemExit(f"gn_plan's shared memory {plan.smem} is not "
                             f"the launch's {smem} at {direction} "
                             f"[{b},{hw},{c}]")
        if clusters < 1:
            raise SystemExit(f"no cluster of {plan.k} fits the card at "
                             f"{direction} [{b},{hw},{c}]")
        out["max_active_clusters"] = clusters
        out["waves"] = -(-b * plan.splits // clusters)
    return out


def _other_k(gn, b, hw, c, g, direction, k, splits):
    """The one-pass cluster size beside the chosen ``k`` (2k, else k/2)
    that can take the call over the same channel splits, or None."""
    import torch

    for other in (2 * k, k // 2):
        try:
            gn.launch_plan(b, hw, c, g, torch.bfloat16, direction, "cuda",
                           k=other, splits=splits)
            return other
        except ValueError:
            continue
    return None


def _time_group_norm(gn, torch, F, mix):
    """(b) Per launch at each (shape, ReLU) of the path, bf16: both
    kernels on the route ``launch_plan`` chooses, their plain versions and
    ``F.group_norm`` (+ ReLU) forward (graph replay) and backward
    (profiler device time); where the one-pass route is chosen, the
    two-pass route and the one-pass route at the other cluster size
    beside it."""
    out = {}
    gen = torch.Generator(device="cuda").manual_seed(6)
    for key in sorted(mix):
        b, hw, c, g, relu = key
        x, dy, gamma, beta = _gn_case(gn, torch, gen, key, torch.bfloat16)
        kw = dict(groups=g, relu=relu)
        _, mean, inv = gn.group_norm_fwd(x, gamma, beta, **kw)
        x4 = x.view(b, hw, 1, c).permute(0, 3, 1, 2)   # channels-last
        gb, bb = gamma.bfloat16(), beta.bfloat16()

        def library():
            y = F.group_norm(x4, g, gb, bb, eps=1e-6)
            return F.relu(y) if relu else y

        xl, gl, bl = (t.detach().clone().requires_grad_()
                      for t in (x4, gb, bb))
        yl = F.group_norm(xl, g, gl, bl, eps=1e-6)
        yl = F.relu(yl) if relu else yl
        dyl = dy.view(b, hw, 1, c).permute(0, 3, 1, 2)
        row = {
            "fwd_ms": _time_ms(lambda: gn.group_norm_fwd(x, gamma, beta,
                                                         **kw), 20),
            "fwd_plain_ms": _time_ms(lambda: gn.group_norm_fwd_reference(
                x, gamma, beta, **kw), 5),
            "fwd_library_ms": _time_ms(library, 20),
            "bwd_ms": _time_ms(lambda: gn.group_norm_bwd(
                x, dy, gamma, beta, mean, inv, **kw), 20),
            "bwd_plain_ms": _time_ms(lambda: gn.group_norm_bwd_reference(
                x, dy, gamma, beta, mean, inv, **kw), 5),
            "bwd_library_ms": _profiled_ms(lambda: torch.autograd.grad(
                yl, (xl, gl, bl), dyl, retain_graph=True), 10),
            "fwd_bound_ms": _gn_bound(b, hw, c, g, "bfloat16", False),
            "bwd_bound_ms": _gn_bound(b, hw, c, g, "bfloat16", True)}
        note = ""
        for pre in ("fwd", "bwd"):
            plan = _gn_route(gn, b, hw, c, g, pre)
            row[f"{pre}_plan"] = plan
            if plan["route"] != "one_pass":
                continue
            calls = {"fwd": lambda **o: gn._fwd_kernel(
                x, gamma, beta, eps=1e-6, **kw, **o),
                     "bwd": lambda **o: gn._bwd_kernel(
                x, dy, gamma, beta, mean, inv, **kw, **o)}
            row[f"{pre}_two_pass_ms"] = _time_ms(
                lambda: calls[pre](route="two_pass"), 20)
            other = _other_k(gn, b, hw, c, g, pre, plan["k"],
                             plan["splits"])
            if other:
                plan["other_k"] = other
                row[f"{pre}_other_k_ms"] = _time_ms(
                    lambda: calls[pre](k=other, splits=plan["splits"]), 20)
            note += (f"; {pre} one-pass splits={plan['splits']} "
                     f"k={plan['k']} rows={plan['rows']} "
                     f"smem={plan['smem']} clusters at once="
                     f"{plan['max_active_clusters']} (two-pass "
                     f"{row[f'{pre}_two_pass_ms']:.4f} ms"
                     + (f", k={other} {row[f'{pre}_other_k_ms']:.4f} ms"
                        if other else "") + ")")
        out[key] = row
        print(f"timing group_norm [{b},{hw},{c}] G={g} relu={relu} bf16 "
              f"(x{mix[key]} per step): fwd {row['fwd_ms']:.4f} ms (plain "
              f"{row['fwd_plain_ms']:.4f}, F.group_norm "
              f"{row['fwd_library_ms']:.4f}, bound "
              f"{row['fwd_bound_ms']:.5f}); bwd {row['bwd_ms']:.4f} ms "
              f"(plain {row['bwd_plain_ms']:.4f}, F.group_norm "
              f"{row['bwd_library_ms']:.4f}, bound "
              f"{row['bwd_bound_ms']:.5f})" + note)
    return out


def _group_names(sd):
    """A ``norm="group_pallas"`` state_dict under ``norm="group"``'s
    names (flax nests ``GroupNorm_0`` there)."""
    import re

    return {re.sub(r"(AdaptiveGroupNorm_\d+)\.(scale|bias)$",
                   r"\1.GroupNorm_0.\2", k): v for k, v in sd.items()}


def _gn_grads_agree(start, batch, torch, np):
    """(c) Step 1's gradient of every parameter through norm=
    "group_pallas" against norm="group" from the same start on the same
    batch, in f32 and in bf16.  The norms' parameters are drawn at random
    around their init first (scales 1 + 0.1 N, the zero-initialized ones
    0.1 N, biases 0.05 N), so every block branch is live and every
    parameter has a gradient."""
    from torch.func import functional_call

    from distkeras_tpu_torch import build_model
    from distkeras_tpu_torch.models import model_config
    from distkeras_tpu_torch.ops.losses import resolve_loss

    rng = np.random.default_rng(7)
    drawn = {}
    for k, v in start.items():
        v = v.detach().float().cpu()
        if k.endswith(("scale", "bias")) and "Dense" not in k:
            noise = torch.from_numpy(
                rng.standard_normal(v.shape).astype(np.float32))
            if k.endswith("bias"):
                v = 0.05 * noise
            else:
                v = (v != 0) + 0.1 * noise
        drawn[k] = v

    def grads(norm, dtype):
        sd = drawn if norm == "group_pallas" else _group_names(drawn)
        model = build_model(model_config(
            "resnet", (IMAGE, IMAGE, 3),
            **{**RESNET, "norm": norm, "dtype": dtype}), device="cuda")
        params = {n: sd[n].to("cuda").requires_grad_()
                  for n, _ in model.named_parameters()}
        logits = functional_call(model, params, (batch["features"],))
        loss = resolve_loss(PS["loss"])(logits, batch["label"])
        out = torch.autograd.grad(loss, list(params.values()))
        # pallas names, in the same module order for both norms
        return dict(zip(drawn, out)), float(loss.detach())

    def compare(got, want):
        total = torch.stack([g.norm() for g in want.values()]).norm().item()
        norm = torch.stack([g.norm() for g in got.values()]).norm().item()
        worst = {}
        for name, g in got.items():
            scale = max(want[name].norm().item(), 1e-3 * total)
            err = (g - want[name]).norm().item() / scale
            worst[name] = err
        return abs(norm / total - 1), worst

    def kinds(worst):
        out: dict = {}
        for name, err in worst.items():
            kind = name.rsplit(".", 1)[-1] + ("" if "Conv" in name
                                              or "Dense" in name
                                              else "(norm)")
            out[kind] = max(out.get(kind, 0.0), err)
        return " ".join(f"{k}={v:.3g}" for k, v in out.items())

    res = {}
    ref = None
    for dtype in ("float32", "bfloat16"):
        got, loss_k = grads("group_pallas", dtype)
        want, loss_f = grads("group", dtype)
        gdiff, worst = compare(got, want)
        res[dtype] = {"loss": [loss_k, loss_f], "grad_norm_rel_diff": gdiff,
                      "worst_rel_err": max(worst.values())}
        if dtype == "float32":
            ref = got
            bad = {n: e for n, e in worst.items() if not e <= TOL_GN_GRAD}
            if bad:
                raise SystemExit(f"step 1 gradients in f32, group_pallas "
                                 f"against group: relative errors {bad}")
        else:
            res[dtype]["pallas_vs_f32"] = max(compare(got, ref)[1].values())
            res[dtype]["group_vs_f32"] = max(compare(want, ref)[1].values())
        print(f"ps: step 1 {dtype}: loss group_pallas {loss_k:.6f} vs "
              f"group {loss_f:.6f}; global grad norm relative diff "
              f"{gdiff:.4g} (tolerance {TOL_GN_GNORM}); largest relative "
              f"error by kind: {kinds(worst)}"
              + ("" if dtype == "float32" else
                 f"; against f32 group_pallas: largest "
                 f"{res[dtype]['pallas_vs_f32']:.3g}, group: "
                 f"{res[dtype]['group_vs_f32']:.3g}"))
        if not gdiff <= TOL_GN_GNORM:
            raise SystemExit(f"group_pallas and group step-1 gradient "
                             f"norms disagree in {dtype}")
    return res


# device time by class on the PS path: the GroupNorm kernels; the
# convolutions (cuDNN's kernels and layout transforms, and the GEMMs it
# runs the 1x1 convolutions as; the head's small product lands here
# too); the optimizer and the commits by their profiler ranges; the rest
# (elementwise: weight casts, residual adds, pads, pooling, the loss)
PS_CLASSES = (("group_norm_fwd", tuple(f"::{k}" for k in
                                        GN_KERNELS["group_norm_fwd"])),
              ("group_norm_bwd", tuple(f"::{k}" for k in
                                        GN_KERNELS["group_norm_bwd"])),
              ("conv_gemm", ("conv", "cudnn", "xmma", "fprop", "dgrad",
                             "wgrad", "implicit", "Nhwc", "nhwc", "nchw",
                             "Nchw", "nvjet", "gemm", "cutlass")))


def _ps_profile(cfg, data, seed, start, wall, torch):
    """One round of the trainer under ``torch.profiler`` (host and
    device): ``ADAG`` trains one more epoch (4 rounds) from ``start``,
    with a profiler step at each round's commit order (the trainer draws
    one per round, just before it stacks that round's batches), and the
    third round is recorded.  Metrics come to the host one round late,
    so that window holds the tail of the round before and most of its
    own.  Device time by kernel class and by the port's ranges; busy
    share against ``wall``, the unprofiled round's time."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from distkeras_tpu_torch import ADAG

    trainer = ADAG(cfg, num_epoch=1, seed=seed, learning_rate=PS_LR,
                   lr_law="scale", device="cuda", **PS)
    orders, seen = trainer.commit_orders(), []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=1, warmup=1, active=1, repeat=1),
                 on_trace_ready=seen.append) as prof:
        def stepping():
            for i, perm in enumerate(orders):
                if i:
                    prof.step()
                yield perm

        trainer.commit_orders = stepping
        trainer.train(data, initial_variables=start)
        torch.cuda.synchronize()
    if len(seen) != 1:
        raise SystemExit(f"the profiler recorded {len(seen)} rounds")
    kernels = _device_kernels(prof, torch)
    launched = sum(ev.count for ev in prof.key_averages()
                   if ev.device_type == torch.autograd.DeviceType.CUDA
                   and ev.key in kernels)
    classes = {name: 0.0 for name, _ in PS_CLASSES}
    classes["other"] = 0.0
    for kname, ms in kernels.items():
        cls = next((name for name, marks in PS_CLASSES
                    if any(m in kname for m in marks)), "other")
        classes[cls] += ms
    ranges = {r: 0.0 for r in RANGES}
    host = {r: 0.0 for r in RANGES}
    for ev in prof.events():
        if ev.name in RANGES and ev.device_type \
                == torch.autograd.DeviceType.CPU:
            ranges[ev.name] += ev.device_time_total / 1e3
            host[ev.name] += ev.cpu_time_total / 1e3
    # the optimizer's and the commits' kernels are elementwise ones:
    # take them out of "other"
    classes["optimizer"] = ranges["optimizer_update"]
    classes["commits"] = ranges["ps_commits"]
    classes["elementwise"] = classes.pop("other") - sum(ranges.values())
    busy = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    print(f"ps profile: one round of the trainer, unprofiled round "
          f"{wall * 1e3:.3f} ms, device busy "
          f"{busy:.3f} ms in {launched} kernels, idle share "
          f"{1 - busy / 1e3 / wall:.4f}; by class "
          f"(ms): " + " ".join(f"{k}={v:.3f}" for k, v in classes.items()))
    print(f"ps profile: host time in the ranges (profiled, so inflated "
          f"by the profiler's own cost), ms: commits "
          f"{host['ps_commits']:.3f} optimizer "
          f"{host['optimizer_update']:.3f}")
    for name, ms in top:
        print(f"ps profile:   {ms:9.3f} ms  {name[:90]}")
    return {"round_wall_ms": wall * 1e3, "device_busy_ms": busy,
            "idle_share": 1 - busy / 1e3 / wall, "kernels": launched,
            "by_class_ms": classes,
            "host_ms_profiled": host, "top_kernels_ms": dict(top)}


def _ps_train(seed, torch, np):
    """Phase 5 (d)-(f): ADAG trains ResNet-50-GroupNorm through the
    faithful commit rounds; then AEASGD at smaller depth; then round and
    step times, MFU and device time by class.  Returns the numbers and
    the GroupNorm launch counts of the ADAG run."""
    from distkeras_tpu_torch import ADAG, AEASGD
    from distkeras_tpu_torch.data import datasets
    from distkeras_tpu_torch.models import model_config
    from distkeras_tpu_torch.ops import group_norm as gn
    from distkeras_tpu_torch.workers import TrainState, make_train_step

    t_phase = time.monotonic()
    cfg = model_config("resnet", (IMAGE, IMAGE, 3), **RESNET)
    trainer = ADAG(cfg, num_epoch=PS_EPOCHS, seed=seed, learning_rate=PS_LR,
                   lr_law="scale", device="cuda", **PS)
    n_params = sum(p.numel() for p in trainer.model.parameters())
    w, k, b = PS["num_workers"], PS["communication_window"], \
        PS["batch_size"]
    mix, fwd_flops = _resnet_shapes(trainer.model, b, torch)
    per_step = sum(mix.values())
    print(f"ps: ResNet-50 params={n_params} GroupNorms per step={per_step} "
          f"shapes={len(mix)} forward GFLOP per image={fwd_flops / 1e9:.4f}"
          f" lr={trainer.learning_rate} (lr_law='scale' from {PS_LR})")
    t0 = time.monotonic()
    data = datasets.imagenet_synth(PS_ROWS, image_size=IMAGE,
                                   num_classes=RESNET["num_classes"],
                                   seed=seed)
    print(f"ps: imagenet_synth({PS_ROWS}) made in "
          f"{time.monotonic() - t0:.1f} s")
    start = {n: v.clone() for n, v in trainer.model.state_dict().items()}

    torch.cuda.synchronize()
    _reset_gn(gn)
    trainer.train(data)
    torch.cuda.synchronize()
    launches = _gn_counts(gn)
    routes = dict(gn.route_launches)
    copies = gn.gradient_copies
    hist = trainer.history
    losses, epochs = hist["round_loss"], hist["epoch_loss"]
    rounds = len(losses)
    print(f"ps: ADAG rounds={rounds} epoch_loss={epochs} round_loss="
          f"{np.round(losses, 4).tolist()} staleness={hist['staleness']} "
          f"clock={trainer.parameter_server_state.clock} launches={launches}"
          f" by route={routes} gradient_copies={copies} training_time_s="
          f"{trainer.training_time:.3f}")
    want = per_step * w * k * rounds
    if rounds < 4 * PS_EPOCHS or any(n != want
                                     for n in launches.values()):
        raise SystemExit(f"GroupNorm launches on the PS path {launches} "
                         f"over {rounds} rounds; expected {want} each "
                         f"({per_step} x {w} workers x window {k} per "
                         f"round)")
    # every bf16 GroupNorm of the path on the one-pass route
    if routes != {"fwd_one_pass": want, "fwd_two_pass": 0,
                  "bwd_one_pass": want, "bwd_two_pass": 0}:
        raise SystemExit(f"GroupNorm routes on the PS path {routes}; "
                         f"expected all {want} of each direction one-pass")
    if not np.isfinite(losses).all() or not epochs[1] < epochs[0]:
        raise SystemExit(f"ADAG losses not finite or not falling: {epochs}")
    if any(sorted(s) != list(range(w)) for s in hist["staleness"]) \
            or trainer.parameter_server_state.clock != w * rounds:
        raise SystemExit("commit staleness or PS clock off")

    batch0 = {c: torch.from_numpy(data[c][:b]).to("cuda")
              for c in ("features", "label")}
    grads = _gn_grads_agree(start, batch0, torch, np)

    # (e) the elastic rule on the card, at smaller depth
    small = model_config("resnet", (IMAGE, IMAGE, 3),
                         **{**RESNET, "stage_sizes": AEASGD_STAGES})
    elastic = AEASGD(small, num_epoch=1, seed=seed, device="cuda", **PS)
    elastic.train(data.take(AEASGD_ROWS))
    e_loss = elastic.history["round_loss"]
    print(f"ps: AEASGD stages={AEASGD_STAGES} alpha={elastic.alpha} rounds="
          f"{len(e_loss)} round_loss={np.round(e_loss, 4).tolist()} clock="
          f"{elastic.parameter_server_state.clock}")
    if not (len(e_loss) and np.isfinite(e_loss).all()
            and elastic.parameter_server_state.clock == w * len(e_loss)):
        raise SystemExit("AEASGD losses not finite or its clock off")
    del elastic

    # (f) the trainer's own round time: its second epoch's wall (the
    # shuffle, per-worker stacking, the copies to the card, the rounds
    # and the metrics' drain) over that epoch's rounds
    per_epoch = rounds // PS_EPOCHS
    round_s = trainer.epoch_time_s[1] / per_epoch
    stall_s = hist["segment_stall_s"][1]
    # one step of a worker alone, on the trained center
    tx = trainer._tx()
    worker = TrainState.create(trainer.model, trainer.trained_variables, tx,
                               device="cuda")
    step = make_train_step(trainer.model, trainer.loss, tx)
    step_times = []
    for _ in range(6):
        t0 = time.monotonic()
        step(worker, batch0)
        torch.cuda.synchronize()
        step_times.append(time.monotonic() - t0)
    step_s = float(np.median(step_times[1:]))
    del worker
    images = w * k * b
    train_flops = 3.0 * fwd_flops        # forward + backward (2x)
    res = {"params": n_params, "group_norms_per_step": per_step,
           "group_norm_launches_per_round": per_step * w * k,
           "group_norm_routes": routes,
           "fwd_gflop_per_image": fwd_flops / 1e9, "rounds": rounds,
           "epoch_loss": epochs, "round_loss": losses,
           "staleness": hist["staleness"], "lr": trainer.learning_rate,
           "ps_clock": trainer.parameter_server_state.clock,
           "gradient_copies": copies,
           "training_time_s": trainer.training_time,
           "aeasgd_round_loss": e_loss, "step1_grads": grads,
           "round_ms": round_s * 1e3, "epoch_time_s": trainer.epoch_time_s,
           "epoch2_shuffle_s": stall_s,
           "step_ms": step_s * 1e3, "images_per_s": images / round_s,
           "mfu": train_flops * images / round_s / PEAK_FLOPS["bfloat16"],
           "step_mfu": train_flops * b / step_s / PEAK_FLOPS["bfloat16"]}
    print(f"ps: round_ms={res['round_ms']:.3f} (the trainer's epoch 2: "
          f"{trainer.epoch_time_s[1]:.4f} s over {per_epoch} rounds, "
          f"{stall_s:.4f} s of it the shuffle; epoch 1 "
          f"{trainer.epoch_time_s[0]:.4f} s) step_ms="
          f"{res['step_ms']:.3f} images_per_s={res['images_per_s']:.1f} "
          f"(one card) mfu={res['mfu']:.4f} step_mfu={res['step_mfu']:.4f} "
          f"(analytic conv FLOPs x3 against 989 TFLOP/s)")
    res["profile"] = _ps_profile(cfg, data, seed, trainer.trained_variables,
                                 round_s, torch)
    res["phase_s"] = time.monotonic() - t_phase
    print(f"ps: phase took {res['phase_s']:.1f} s")
    return res, launches


# ---- phase 6: the fused ResNet path (kernels #7-#10) -----------------

# scripts/perf_fused_e2e.py's configuration, not cut: ResNet-50, 224 px,
# s2d stem, bf16 compute, f32 masters, fusion="pallas_block" (every
# bottleneck through the fused-block kernels), momentum SGD at lr 0.1,
# batch 256; only the run length is short (2 epochs of 4 steps)
FUSED = dict(num_classes=1000, stage_sizes=(3, 4, 6, 3), bottleneck=True,
             stem="space_to_depth", norm="group", dtype="bfloat16",
             fusion="pallas_block")
FUSED_TRAIN = dict(loss="sparse_categorical_crossentropy",
                   worker_optimizer="momentum", learning_rate=0.1,
                   batch_size=256)
FUSED_ROWS, FUSED_EPOCHS = 1024, 2
FUSED_GRAD_BATCH = 32              # fused against unfused step-1 gradients
# pallas_tail with fusion_stages at smaller depth: the tail-only block
# and the per-class block names
TAIL_RUN = dict(fusion="pallas_tail", fusion_stages=(0, 1),
                stage_sizes=(1, 1, 1, 1))
TAIL_ROWS = 512                    # 2 steps of 256
# The kernels against their plain versions, per element scaled by
# |plain| + rms(plain) as the GroupNorm kernels are held.  f32: summation
# order only, 1e-4 for every output.  bf16: y and dres may round to the
# neighbouring value (one ulp, 2^-7).  dx, dw, dy2 and the tail's out
# are products of an intermediate rounded to bf16 (dy_raw, the tail's h
# or dy3), which the two sides may round to neighbouring values at a few
# elements: a flip moves an entry by up to ulp(term), a share of its
# typical size that grows with the term's size, on top of the entry's
# own rounding: 2^-6, as the flash backward is held (2^-7 failed on the
# card, PERF.md).  The f32 parameter gradients: conv's dgamma, dbeta sum
# unrounded terms (1e-4); the tail's dg2, db2, dg3, db3 sum terms behind
# its rounded h or dy3 (2^-9)
TOL_FB = {"bfloat16": 2 ** -7, "float32": 1e-4}
TOL_FB_ROUNDED = {"bfloat16": 2 ** -6, "float32": 1e-4}
TOL_FB_SUMS = 1e-4
TOL_FB_TAIL_SUMS = {"bfloat16": 2 ** -9, "float32": 1e-4}
# The two sides take their statistics in different orders, so a ReLU test
# that sits at its boundary may go either way (and in bf16 a neighbouring
# rounding of the tail's h moves z3 by ~1e-3 of its scale): the check's
# inputs keep every test at least 2^-8 of its terms' size away from it.
# Incoming gradients are zeroed there; the tail's inner test is moved by
# nudging those y2 entries.  About 0.3 % of the elements.
RELU_BAND = 2 ** -8
FB_EPS = 1e-6
FB_KERNELS = ("conv1x1_gn_fwd", "conv1x1_gn_bwd", "bottleneck_tail_fwd",
              "bottleneck_tail_bwd")


def _fb_counts(fb):
    return dict(zip(FB_KERNELS, (fb.conv_gn_fwd_launches,
                                 fb.conv_gn_bwd_launches,
                                 fb.tail_fwd_launches,
                                 fb.tail_bwd_launches)))


def _reset_fb(fb):
    fb.conv_gn_fwd_launches = fb.conv_gn_bwd_launches = 0
    fb.tail_fwd_launches = fb.tail_bwd_launches = 0
    fb.input_copies = fb.gradient_copies = 0


def _map_block_params(sd):
    """An unfused ``BottleneckBlock`` state_dict (``norm="group"``) ->
    ``FusedBottleneckBlock``'s names and layouts (the JAX package's
    ``tests/test_fused_block.py`` mapping, on the port's names)."""
    def conv(i):
        return sd[f"Conv_{i}.weight"][:, :, 0, 0].T.contiguous()

    def gn(i, tag):
        pre = f"AdaptiveGroupNorm_{i}.GroupNorm_0"
        return {f"{tag}_scale": sd[f"{pre}.scale"],
                f"{tag}_bias": sd[f"{pre}.bias"]}

    out = {"conv1": conv(0), "conv2.weight": sd["Conv_1.weight"],
           "conv3": conv(2), **gn(0, "gn1"), **gn(1, "gn2"), **gn(2, "gn3")}
    if "Conv_3.weight" in sd:
        out.update({"convd": conv(3), **gn(3, "gnd")})
    return out


def _fuse_params(sd):
    """A ``fusion="none"`` ResNet's state_dict (or gradients) under
    ``fusion="pallas_block"``'s names: ``BottleneckBlock_i`` ->
    ``FusedBottleneckBlock_i``, the rest unchanged."""
    out, blocks = {}, {}
    for k, v in sd.items():
        head, _, rest = k.partition(".")
        if head.startswith("BottleneckBlock_"):
            blocks.setdefault(head, {})[rest] = v
        else:
            out[k] = v
    for head, bsd in blocks.items():
        for k, v in _map_block_params(bsd).items():
            out[f"Fused{head}.{k}"] = v
    return out


def _fused_shapes(fb, model, batch, torch):
    """One forward at ``batch``: the calls of the two fused functions as
    ``{(B, HW, Cin, Cout, G, relu): n}`` and ``{(B, HW, Cm, Cout, G2,
    G3): n}`` (recorded around the module's entry points)."""
    conv, tail = {}, {}
    fwd, tail_fwd = fb.conv1x1_gn_fwd, fb.bottleneck_tail_fwd

    def rec_conv(x3, w, gamma, beta, *, groups, eps=FB_EPS, relu=True):
        key = (*x3.shape[:2], *w.shape, groups, relu)
        conv[key] = conv.get(key, 0) + 1
        return fwd(x3, w, gamma, beta, groups=groups, eps=eps, relu=relu)

    def rec_tail(y2, w, g2, b2, g3, b3, res, *, groups2, groups3,
                 eps=FB_EPS):
        key = (*y2.shape[:2], *w.shape, groups2, groups3)
        tail[key] = tail.get(key, 0) + 1
        return tail_fwd(y2, w, g2, b2, g3, b3, res, groups2=groups2,
                        groups3=groups3, eps=eps)

    fb.conv1x1_gn_fwd, fb.bottleneck_tail_fwd = rec_conv, rec_tail
    try:
        with torch.no_grad():
            model(torch.zeros(batch, IMAGE, IMAGE, 3, device="cuda"))
    finally:
        fb.conv1x1_gn_fwd, fb.bottleneck_tail_fwd = fwd, tail_fwd
    return conv, tail


def _away(t, terms):
    """Where ``t`` (a ReLU test's value) lies within ``RELU_BAND`` of its
    terms' size from 0."""
    return t.abs() <= RELU_BAND * (terms + 1.0)


def _conv_gn_case(fb, torch, gen, key, dtype):
    """Inputs of ``fused_conv1x1_gn`` at ``key``: x, w (fan-in scaled),
    gamma, beta, and an incoming gradient that is 0 where the ReLU test
    sits at its boundary."""
    b, hw, cin, cout, g, relu = key
    x = torch.randn(b, hw, cin, device="cuda", generator=gen).to(dtype)
    w = (torch.randn(cin, cout, device="cuda", generator=gen)
         * cin ** -0.5).to(dtype)
    gamma = torch.randn(cout, device="cuda", generator=gen) * 0.5 + 1
    beta = torch.randn(cout, device="cuda", generator=gen) * 0.1
    dy = torch.randn(b, hw, cout, device="cuda", generator=gen).to(dtype)
    if relu:
        y = x.float() @ w.float()
        mean, inv = fb._gn_stats(y, g, FB_EPS)
        t = (y - mean) * inv * gamma
        dy = torch.where(_away(t + beta, t.abs() + beta.abs()), 0.0, dy)
        del y, t
    return x, w, gamma, beta, dy


def _tail_case(fb, torch, gen, key, dtype):
    """Inputs of ``fused_bottleneck_tail`` at ``key``: y2 (nudged where
    h's ReLU test sits at its boundary), w, the four rows, the residual,
    and an incoming gradient that is 0 where the final ReLU's test
    does."""
    b, hw, cm, cout, g2, g3 = key

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    y2 = (randn(b, hw, cm) * 2 + 0.5).to(dtype)
    w = (randn(cm, cout) * cm ** -0.5).to(dtype)
    p2 = (randn(cm) * 0.3 + 1, randn(cm) * 0.1)
    p3 = (randn(cout) * 0.3 + 0.5, randn(cout) * 0.1)
    res, dout = randn(b, hw, cout).to(dtype), randn(b, hw, cout).to(dtype)
    for _ in range(5):
        mean2, inv2 = fb._gn_stats(y2.float(), g2, FB_EPS)
        t = (y2.float() - mean2) * inv2 * p2[0]
        near = _away(t + p2[1], t.abs() + p2[1].abs())
        if not near.any():
            break
        step = torch.where(t + p2[1] >= 0, 0.05, -0.05) / (inv2 * p2[0])
        y2 = torch.where(near, y2.float() + step, y2.float()).to(dtype)
    else:
        raise SystemExit("could not move the tail's inputs off the ReLU "
                         "boundary")
    del mean2, inv2, t, near
    chain = fb._tail_chain(y2, w, *p2, *p3, res, g2, g3, FB_EPS)
    t = chain[4] * p3[0]
    dout = torch.where(_away(chain[6], t.abs() + p3[1].abs()
                             + res.float().abs()), 0.0, dout)
    del chain, t
    return y2, w, *p2, *p3, res, dout


def _fb_tol(name, dname):
    """The tolerance of output ``name`` in ``dname`` (see ``TOL_FB``)."""
    if name in ("dx", "dw", "dy2", "out"):
        return TOL_FB_ROUNDED[dname]
    if name in ("dgamma", "dbeta"):
        return TOL_FB_SUMS
    if name in ("dg2", "db2", "dg3", "db3"):
        return TOL_FB_TAIL_SUMS[dname]
    return TOL_FB[dname]


def _hold(kind, key, dname, names, got, want, torch):
    row = {"kernel": kind, "key": list(key), "dtype": dname}
    ok = True
    for name, a, w in zip(names, got, want):
        ratio = _ratio(a, w)
        row[f"{name}_ratio"] = ratio
        row[f"{name}_err"] = (a.float() - w.float()).abs().max().item()
        ok = (ok and ratio <= _fb_tol(name, dname)
              and bool(torch.isfinite(a).all()))
    row["ok"] = ok
    print(f"fused_block {row}")
    if not ok:
        raise SystemExit(f"the fused-block kernels disagree with their "
                         f"plain versions: {row}")
    return row


def _rerun(row, first, again, torch):
    """A bf16 forward and backward run twice on the same inputs must give
    the same bits (no atomics; every sum in a fixed order)."""
    if again is None:
        return
    row["rerun_bit_equal"] = all(torch.equal(a, b)
                                 for a, b in zip(first, again))
    print(f"fused_block {row['kernel']} {row['key']} bf16 forward and "
          f"backward rerun bit-equal: {row['rerun_bit_equal']}")
    if not row["rerun_bit_equal"]:
        raise SystemExit(f"the bf16 {row['kernel']} kernels are not "
                         f"deterministic at {row['key']}")


def _check_fused(fb, torch, conv_keys, tail_keys):
    """(a) The four kernels against their plain versions at every call
    shape of the path, bf16 and f32, with the path's ReLU settings."""
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(8)
    for key in conv_keys:
        for dname in ("bfloat16", "float32"):
            x, w, gamma, beta, dy = _conv_gn_case(fb, torch, gen, key,
                                                  getattr(torch, dname))
            kw = dict(groups=key[4], relu=key[5])
            got = (fb.conv1x1_gn_fwd(x, w, gamma, beta, **kw),
                   *fb.conv1x1_gn_bwd(x, w, gamma, beta, dy, **kw))
            want = (fb.conv1x1_gn_fwd_reference(x, w, gamma, beta, **kw),
                    *fb.conv1x1_gn_bwd_reference(x, w, gamma, beta, dy,
                                                 **kw))
            again = ((fb.conv1x1_gn_fwd(x, w, gamma, beta, **kw),
                      *fb.conv1x1_gn_bwd(x, w, gamma, beta, dy, **kw))
                     if dname == "bfloat16" else None)
            torch.cuda.synchronize()
            rows.append(_hold("conv1x1_gn", key, dname,
                              ("y", "dx", "dw", "dgamma", "dbeta"), got,
                              want, torch))
            _rerun(rows[-1], got, again, torch)
            del x, w, dy, got, want, again
    for key in tail_keys:
        for dname in ("bfloat16", "float32"):
            args = _tail_case(fb, torch, gen, key, getattr(torch, dname))
            kw = dict(groups2=key[4], groups3=key[5])
            got = (fb.bottleneck_tail_fwd(*args[:7], **kw),
                   *fb.bottleneck_tail_bwd(*args, **kw))
            want = (fb.bottleneck_tail_fwd_reference(*args[:7], **kw),
                    *fb.bottleneck_tail_bwd_reference(*args, **kw))
            again = ((fb.bottleneck_tail_fwd(*args[:7], **kw),
                      *fb.bottleneck_tail_bwd(*args, **kw))
                     if dname == "bfloat16" else None)
            torch.cuda.synchronize()
            rows.append(_hold("bottleneck_tail", key, dname,
                              ("out", "dy2", "dw", "dg2", "db2", "dg3",
                               "db3", "dres"), got, want, torch))
            _rerun(rows[-1], got, again, torch)
            del args, got, want, again
    torch.cuda.empty_cache()
    return rows


def _stage_keys(keys):
    """One call shape per stage of the path: the first key (sorted) at
    each row count HW, the widest HW first."""
    first = {}
    for key in sorted(keys):
        first.setdefault(key[1], key)
    return [first[hw] for hw in sorted(first, reverse=True)]


def _check_fwd_plans(fb, torch, conv_keys, tail_keys):
    """(a') The bf16 forwards under both pass plans (``fwd_plan``'s
    ``store``) at one call shape per stage must give the same bits.  The
    store plan applies the statistics to P1's own f32 product, the
    recompute plan to the product P2 computes again, in the same
    rounding steps: equal outputs show that P2's product is P1's, so the
    statistics are those of the y they are applied to."""
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(11)
    for kind, keys in (("conv", conv_keys), ("tail", tail_keys)):
        for key in _stage_keys(keys):
            if kind == "conv":
                args = _conv_gn_case(fb, torch, gen, key, torch.bfloat16)[:4]
                kw = dict(groups=key[4], eps=FB_EPS, relu=key[5])
                fn = fb._conv_gn_fwd_kernel
            else:
                args = _tail_case(fb, torch, gen, key, torch.bfloat16)[:7]
                kw = dict(groups2=key[4], groups3=key[5], eps=FB_EPS)
                fn = fb._tail_fwd_kernel
            kept = fn(*args, **kw, store=True)
            again = fn(*args, **kw, store=False)
            torch.cuda.synchronize()
            row = {"kernel": kind, "key": list(key),
                   "bit_equal": torch.equal(kept, again),
                   "max_abs_diff": (kept.float() - again.float()).abs()
                   .max().item()}
            print(f"fused_block {kind} {list(key)} bf16 forward, kept y "
                  f"against recomputed y: bit-equal {row['bit_equal']} "
                  f"(max |diff| {row['max_abs_diff']})")
            if not row["bit_equal"]:
                raise SystemExit(f"the bf16 {kind} forward's two plans "
                                 f"disagree at {key}: P2's product is not "
                                 f"P1's")
            rows.append(row)
            del args, kept, again
    return rows


def _fb_bound(kind, key, backward):
    """Least time (ms) of one bf16 launch and what bounds it: each input
    read once and each output written once (dw in f32, as the kernels
    write it), and the products the function needs (the backward needs
    the forward's product for its statistics, then two more)."""
    b, hw, cin, cout = key[:4]
    rows, item = b * hw, 2
    rows_f = 4 * (2 * cout + (2 * cin if kind == "tail" else 0))
    if kind == "conv":
        nbytes = rows * (cin + cout) * item + cin * cout * item + rows_f
        if backward:
            nbytes += rows * cout * item + cin * cout * 4 + rows_f
    else:
        nbytes = rows * (cin + 2 * cout) * item + cin * cout * item + rows_f
        if backward:
            nbytes += rows * (cin + cout) * item + cin * cout * 4 + rows_f
    flops = 2.0 * rows * cin * cout * (3 if backward else 1)
    t_ops, t_bytes = flops / PEAK_FLOPS["bfloat16"], nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


def _spelled_conv_gn(F, torch, x4, w4, gamma, beta, g, relu):
    """``fusion="none"``'s spelling of the region: cuDNN's 1x1 conv, then
    ``AdaptiveGroupNorm`` as the port runs it (``F.group_norm`` on the f32
    upcast, ReLU, one rounding): 5 calls."""
    y = F.group_norm(F.conv2d(x4, w4).float(), g, gamma, beta, eps=FB_EPS)
    return (F.relu(y) if relu else y).to(x4.dtype)


def _spelled_tail(F, torch, y24, w4, g2, b2, g3, b3, res4, groups2,
                  groups3):
    """The tail as ``BottleneckBlock`` spells it: GN2 + ReLU, the 1x1
    conv, GN3, the residual add and ReLU: 11 calls."""
    h = F.relu(F.group_norm(y24.float(), groups2, g2, b2, eps=FB_EPS)
               ).to(y24.dtype)
    z = F.group_norm(F.conv2d(h, w4).float(), groups3, g3, b3,
                     eps=FB_EPS).to(y24.dtype)
    return F.relu(res4 + z)


SPELLED_CALLS = {"conv": 5, "tail": 11}


def _img4(t):
    """``[B, HW, C]`` rows -> a channels-last ``[B, C, HW, 1]`` view."""
    return t.view(t.shape[0], t.shape[1], 1, t.shape[2]).permute(0, 3, 1, 2)


GRID_CALLS = 10


def _grid_ms(fn, torch):
    """Each kernel one ``fn()`` call launches, by name (a short name for
    the fused product body), from the profiler's trace: its device time
    a call (``ms``) and, where the trace records them, the shared memory
    (bytes, static and dynamic) and the registers a thread it was
    launched with (the largest over its launches).  In each of three
    profiler sessions one call warms the tracer up and the next
    ``GRID_CALLS`` are recorded, issued 50 ms inside their step; the
    reading with the most kernel launches is kept.  The trace's window
    can gain or lose a call's grids at its edges (a trace of one short
    call lost its first grids or all of them), so a grid's time a call
    is its mean over its launches times its launches a call: its
    launches over the lower median of all names' launches (most grids
    are launched once a call).  The trace is written into the kernels'
    build directory and removed."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from distkeras_tpu_torch.ops import _build

    path = _build.BUILD_DIR / "grids_trace.json"
    fn()
    torch.cuda.synchronize()
    best = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p: p.export_chrome_trace(
                         str(path))) as prof:
            for calls in (1, GRID_CALLS):
                time.sleep(0.05)
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
                time.sleep(0.05)
                prof.step()
        kernels = [ev for ev in json.loads(path.read_text())["traceEvents"]
                   if ev.get("cat") == "kernel"]
        path.unlink()
        if len(kernels) > len(best):
            best = kernels
    return _grids_of(best)


def _grids_of(kernels):
    """``_grid_ms``'s reading of the trace's kernel events ``kernels``
    over several calls: by grid name, its device time a call and its
    launch resources."""
    out, launches = {}, {}
    for ev in kernels:
        name = ev["name"]
        m = re.search(r"gemm_kernel<(\d+), (\d+), \w+, \w+, "
                      r"fused_block::tc::(\w+)>", name)
        m2 = re.search(r"::(\w+_kernel)", name)
        key = (f"{m.group(3)}_n{m.group(1)}_w{m.group(2)}" if m
               else m2.group(1) if m2 else name[:40])
        grid = out.setdefault(key, {"ms": 0.0})
        grid["ms"] += ev["dur"] / 1e3
        launches[key] = launches.get(key, 0) + 1
        args = ev.get("args", {})
        for field, label in (("smem", "shared memory"),
                             ("registers", "registers per thread")):
            if label in args:
                grid[field] = max(grid.get(field, 0), int(args[label]))
    counts = sorted(launches.values())
    calls = counts[(len(counts) - 1) // 2] if counts else 1
    for key, grid in out.items():
        grid["ms"] *= max(1, round(launches[key] / calls)) / launches[key]
    return out


def _time_fused(fb, torch, F, conv_mix, tail_mix):
    """(b) Per launch at each call shape of the path, bf16: kernels,
    plain versions and the torch spelling of the same region (forward by
    graph replay; the spelling's backward by profiler device time); each
    kernel's grids from its profiled calls (``_grid_ms``); both forwards
    under both pass
    plans (``fwd_plan``) and #8 under both of its own (``bwd_plan``: y
    kept in f32, or recomputed)."""
    out = {}
    gen = torch.Generator(device="cuda").manual_seed(9)
    for kind, mix in (("conv", conv_mix), ("tail", tail_mix)):
        for key in sorted(mix):
            if kind == "conv":
                args = _conv_gn_case(fb, torch, gen, key, torch.bfloat16)
                kw = dict(groups=key[4], relu=key[5])
                fwd, fwd_ref = fb.conv1x1_gn_fwd, fb.conv1x1_gn_fwd_reference
                bwd, bwd_ref = fb.conv1x1_gn_bwd, fb.conv1x1_gn_bwd_reference
                fwd_kernel, groups = fb._conv_gn_fwd_kernel, key[4]
                fkw = dict(groups=key[4], eps=FB_EPS, relu=key[5])
                fargs = args[:4]
                x4, w, gamma, beta, dy = args
                leaves = [_img4(x4).detach().clone().requires_grad_(),
                          w.t().reshape(key[3], key[2], 1, 1)
                          .contiguous(memory_format=torch.channels_last)
                          .requires_grad_(), gamma.clone()
                          .requires_grad_(), beta.clone().requires_grad_()]
                spell = (lambda a=leaves, k=key: _spelled_conv_gn(
                    F, torch, *a, k[4], k[5]))
            else:
                args = _tail_case(fb, torch, gen, key, torch.bfloat16)
                kw = dict(groups2=key[4], groups3=key[5])
                fwd, fwd_ref = fb.bottleneck_tail_fwd, \
                    fb.bottleneck_tail_fwd_reference
                bwd, bwd_ref = fb.bottleneck_tail_bwd, \
                    fb.bottleneck_tail_bwd_reference
                fwd_kernel, groups = fb._tail_fwd_kernel, key[4:6]
                fkw = dict(groups2=key[4], groups3=key[5], eps=FB_EPS)
                fargs = args[:7]
                y2, w, g2, b2, g3, b3, res, dy = args
                leaves = [_img4(y2).detach().clone().requires_grad_(),
                          w.t().reshape(key[3], key[2], 1, 1)
                          .contiguous(memory_format=torch.channels_last)
                          .requires_grad_()] + [
                    p.clone().requires_grad_() for p in (g2, b2, g3, b3)] + [
                    _img4(res).detach().clone().requires_grad_()]
                spell = (lambda a=leaves, k=key: _spelled_tail(
                    F, torch, *a, k[4], k[5]))
            spelled = spell()
            dy4 = _img4(dy)
            grids = {"fwd_grids": _grid_ms(lambda: fwd(*fargs, **kw), torch),
                     "bwd_grids": _grid_ms(lambda: bwd(*args, **kw), torch)}
            row = {
                "fwd_ms": _time_ms(lambda: fwd(*fargs, **kw), 5),
                "fwd_plain_ms": _time_ms(lambda: fwd_ref(*fargs, **kw), 3),
                "fwd_spelled_ms": _time_ms(spell, 5),
                "bwd_ms": _time_ms(lambda: bwd(*args, **kw), 5),
                "bwd_plain_ms": _time_ms(lambda: bwd_ref(*args, **kw), 3),
                "bwd_spelled_ms": _profiled_ms(lambda: torch.autograd.grad(
                    spelled, leaves, dy4, retain_graph=True), 5), **grids}
            store = fb.fwd_plan(kind, *key[:4], groups,
                                torch.bfloat16)["store"]
            row["fwd_plan"] = "store" if store else "recompute"
            row["fwd_other_plan_ms"] = _time_ms(
                lambda: fwd_kernel(*fargs, **fkw, store=not store), 5)
            if kind == "conv":
                store = fb.bwd_plan("conv", *key[:5], torch.bfloat16)["store"]
                row["bwd_plan"] = "store" if store else "recompute"
                row["bwd_other_plan_ms"] = _time_ms(
                    lambda: fb._conv_gn_bwd_kernel(
                        *args, groups=key[4], eps=FB_EPS, relu=key[5],
                        store=not store), 5)
            for tag, backward in (("fwd", False), ("bwd", True)):
                bound, by, flops, nbytes = _fb_bound(kind, key, backward)
                row[f"{tag}_bound_ms"], row[f"{tag}_bound_by"] = bound, by
                row[f"{tag}_gflop"], row[f"{tag}_mb"] = flops / 1e9, \
                    nbytes / 1e6
            out[(kind, key)] = row
            print(f"timing {kind} {list(key)} bf16 (x{mix[key]} per step): "
                  + " ".join(f"{k}={v:.5f}" if isinstance(v, float)
                             else f"{k}={v}" for k, v in row.items()
                             if not k.endswith("_grids"))
                  + "".join(f" | {pre} grids ms: " + " ".join(
                      f"{g}={d['ms']:.4f}"
                      for g, d in row[f"{pre}_grids"].items())
                      for pre in ("fwd", "bwd")))
            del args, fargs, leaves, spelled, dy4
            torch.cuda.empty_cache()
    return out


def _launched(fb_timing, kind, mix, pre="bwd"):
    """The grids of a bf16 kernel (``pre``: "fwd" or "bwd") over the
    path's call shapes: the shared memory (bytes) and registers a thread
    they were launched with, [least, most] by grid (the product body
    keyed as in its ptxas report), where the profiler's trace records
    them."""
    out = {}
    for k in mix:
        for grid, g in fb_timing[(kind, k)][f"{pre}_grids"].items():
            for f in ("smem", "registers"):
                if f in g:
                    lo, hi = out.setdefault(grid, {}).get(f, (g[f], g[f]))
                    out[grid][f] = [min(lo, g[f]), max(hi, g[f])]
    return dict(sorted(out.items()))


def _plan_means(fb_timing, mix, kind="conv", pre="bwd"):
    """A kernel's launch-weighted times (#8: ``kind`` "conv", ``pre``
    "bwd"; the forwards: "fwd") over the calls where its plan rule keeps
    y ("store") and where it recomputes y: under the chosen plan and
    under the other."""
    out = {}
    for plan in ("store", "recompute"):
        keys = [k for k in mix
                if fb_timing[(kind, k)][f"{pre}_plan"] == plan]
        n = sum(mix[k] for k in keys)
        if n:
            out[plan] = {"calls": n, **{
                f: sum(mix[k] * fb_timing[(kind, k)][field]
                       for k in keys) / n
                for f, field in (("chosen_ms", f"{pre}_ms"),
                                 ("other_ms", f"{pre}_other_plan_ms"))}}
    return out


def _draw_norms(start, torch, np, seed):
    """``start`` with its block norms' parameters drawn around their init
    (scales 1 + 0.1 N, the zero-initialized ones 0.1 N, biases 0.05 N),
    so every branch is live and every parameter has a gradient."""
    rng = np.random.default_rng(seed)
    drawn = {}
    for k, v in start.items():
        v = v.detach().float().cpu()
        if k.endswith(("scale", "bias")) and "Dense" not in k:
            noise = torch.from_numpy(
                rng.standard_normal(v.shape).astype(np.float32))
            v = 0.05 * noise if k.endswith("bias") else (v != 0) + 0.1 * noise
        drawn[k] = v
    return drawn


def _fused_grads_agree(unfused_start, batch, torch, np):
    """(c) Step 1's gradient of every parameter through ``pallas_block``
    against ``fusion="none"`` from mapped weights on one batch, in f32
    (cuDNN without TF32) and bf16."""
    from torch.func import functional_call

    from distkeras_tpu_torch import build_model
    from distkeras_tpu_torch.models import model_config
    from distkeras_tpu_torch.ops.losses import resolve_loss

    drawn = _draw_norms(unfused_start, torch, np, 10)

    def grads(fusion, dtype):
        sd = drawn if fusion == "none" else _fuse_params(drawn)
        model = build_model(model_config(
            "resnet", (IMAGE, IMAGE, 3),
            **{**FUSED, "fusion": fusion, "dtype": dtype}), device="cuda")
        params = {n: sd[n].to("cuda").requires_grad_()
                  for n, _ in model.named_parameters()}
        logits = functional_call(model, params, (batch["features"],))
        loss = resolve_loss(FUSED_TRAIN["loss"])(logits, batch["label"])
        out = torch.autograd.grad(loss, list(params.values()))
        got = dict(zip(params, out))
        return (got if fusion != "none" else _fuse_params(got),
                float(loss.detach()))

    res = {}
    for dtype in ("float32", "bfloat16"):
        got, loss_f = grads("pallas_block", dtype)
        want, loss_u = grads("none", dtype)
        total = torch.stack([g.norm() for g in want.values()]).norm().item()
        norm = torch.stack([g.norm() for g in got.values()]).norm().item()
        gdiff = abs(norm / total - 1)
        worst = {}
        for name, g in got.items():
            scale = max(want[name].norm().item(), 1e-3 * total)
            worst[name] = (g - want[name]).norm().item() / scale
        top = max(worst, key=worst.get)
        res[dtype] = {"loss": [loss_f, loss_u], "grad_norm_rel_diff": gdiff,
                      "worst_rel_err": worst[top], "worst_param": top}
        print(f"fused: step 1 {dtype} at batch {FUSED_GRAD_BATCH}: loss "
              f"pallas_block {loss_f:.6f} vs none {loss_u:.6f}; global "
              f"grad norm relative diff {gdiff:.4g} (tolerance "
              f"{TOL_GN_GNORM}); largest per-parameter relative error "
              f"{worst[top]:.4g} ({top})")
        if not gdiff <= TOL_GN_GNORM:
            raise SystemExit(f"pallas_block and none step-1 gradient norms "
                             f"disagree in {dtype}")
        if dtype == "float32":
            bad = {n: e for n, e in worst.items() if not e <= TOL_GN_GRAD}
            if bad:
                raise SystemExit(f"step 1 gradients in f32, pallas_block "
                                 f"against none: relative errors {bad}")
    return res


# device time by class on the fused path: the fused-block kernels (their
# namespace), the convolutions (cuDNN's kernels and layout transforms;
# the head's small product lands here too), the stem's F.group_norm, the
# optimizer by its range, the rest (casts, pads, pooling, the loss)
FUSED_CLASSES = (("fused_block", ("fused_block::",)),
                 ("stem_group_norm", ("RowwiseMoments", "ComputeFusedParams",
                                      "GroupNorm", "group_norm",
                                      "ComputeInternalGradients",
                                      "ComputeBackwardFusedParams",
                                      "GammaBeta", "Compute1dBackward")),
                 ("conv_gemm", PS_CLASSES[2][1]))


def _fused_profile(step, state, batch, wall, steps, torch):
    """``steps`` fused steps under ``torch.profiler`` (host and device):
    device time by class, idle share against ``wall``, the same steps'
    unprofiled time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step(state, batch)
        torch.cuda.synchronize()
    kernels = _device_kernels(prof, torch)
    classes = {name: 0.0 for name, _ in FUSED_CLASSES}
    classes["other"] = 0.0
    for kname, ms in kernels.items():
        cls = next((name for name, marks in FUSED_CLASSES
                    if any(m in kname for m in marks)), "other")
        classes[cls] += ms
    opt = sum(ev.device_time_total / 1e3 for ev in prof.events()
              if ev.name == "optimizer_update"
              and ev.device_type == torch.autograd.DeviceType.CPU)
    classes["optimizer"] = opt
    classes["other"] -= opt
    busy = sum(kernels.values())
    per = {k: v / steps for k, v in classes.items()}
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    print(f"fused profile: {steps} steps, unprofiled {wall * 1e3:.3f} ms, "
          f"device busy {busy:.3f} ms, idle share "
          f"{1 - busy / 1e3 / wall:.4f}; per step by class (ms): "
          + " ".join(f"{k}={v:.3f}" for k, v in per.items()))
    for name, ms in top:
        print(f"fused profile:   {ms / steps:9.3f} ms/step  {name[:90]}")
    return {"steps": steps, "wall_ms": wall * 1e3, "device_busy_ms": busy,
            "idle_share": 1 - busy / 1e3 / wall, "by_class_ms_per_step": per,
            "top_kernels_ms": dict(top)}


def _step_ms(step, state, batch, torch, np, n=6):
    """Median wall of steps 2..n of ``step``, each ending in a
    synchronize."""
    times = []
    for _ in range(n):
        t0 = time.monotonic()
        step(state, batch)
        torch.cuda.synchronize()
        times.append(time.monotonic() - t0)
    return float(np.median(times[1:])) * 1e3, [t * 1e3 for t in times]


def _fused_train(seed, torch, np, fb, conv_mix, tail_mix, fwd_flops):
    """(d)-(g): SingleTrainer trains the fused ResNet-50 (``conv_mix``,
    ``tail_mix``: its calls per step); the unfused model trains from the
    same weights; determinism; step times of both in turns; profiled
    fused steps; pallas_tail with fusion_stages; then (c)."""
    from distkeras_tpu_torch import SingleTrainer, build_model
    from distkeras_tpu_torch.data import datasets
    from distkeras_tpu_torch.models import model_config
    from distkeras_tpu_torch.workers import (TrainState, make_train_step,
                                             resolve_optimizer)

    t_phase = time.monotonic()
    cfg = model_config("resnet", (IMAGE, IMAGE, 3), **FUSED)
    ref_cfg = model_config("resnet", (IMAGE, IMAGE, 3),
                           **{**FUSED, "fusion": "none"})
    # flax's init of the unfused model, drawn from the seed
    unfused_start = build_model(ref_cfg, device="cpu").init_params(
        torch.Generator().manual_seed(seed + 4))
    start = _fuse_params(unfused_start)
    t0 = time.monotonic()
    data = datasets.imagenet_synth(FUSED_ROWS, image_size=IMAGE,
                                   num_classes=FUSED["num_classes"],
                                   seed=seed)
    print(f"fused: imagenet_synth({FUSED_ROWS}) made in "
          f"{time.monotonic() - t0:.1f} s")
    trainer = SingleTrainer(cfg, num_epoch=FUSED_EPOCHS, seed=seed,
                            **FUSED_TRAIN)
    per_step = {"conv1x1_gn_fwd": sum(conv_mix.values()),
                "conv1x1_gn_bwd": sum(conv_mix.values()),
                "bottleneck_tail_fwd": sum(tail_mix.values()),
                "bottleneck_tail_bwd": sum(tail_mix.values())}
    steps = FUSED_EPOCHS * (FUSED_ROWS // FUSED_TRAIN["batch_size"])
    torch.cuda.synchronize()
    _reset_fb(fb)
    trainer.train(data, initial_variables=start)
    torch.cuda.synchronize()
    launches = _fb_counts(fb)
    copies = (fb.input_copies, fb.gradient_copies)
    loss = trainer.step_metrics["loss"]
    epochs = trainer.history["epoch_loss"]
    print(f"fused: pallas_block steps={len(loss)} epoch_loss={epochs} "
          f"step losses {np.round(loss, 5).tolist()} launches={launches} "
          f"(per step {per_step}) input_copies={copies[0]} "
          f"gradient_copies={copies[1]} training_time_s="
          f"{trainer.training_time:.3f}")
    # one fused conv per block and one per stage's projection, one tail
    # per block: 20/20/16/16 at ResNet-50's depth
    blocks = sum(FUSED["stage_sizes"])
    convs = blocks + len(FUSED["stage_sizes"])
    want = {k: n * steps for k, n in zip(FB_KERNELS, (convs, convs, blocks,
                                                      blocks))}
    if launches != want or {k: n * steps for k, n in per_step.items()} \
            != want:
        raise SystemExit(f"fused kernel launches {launches}; expected "
                         f"{want} ({convs}/{convs}/{blocks}/{blocks} per "
                         f"step)")
    if len(loss) != steps or not np.isfinite(loss).all():
        raise SystemExit("non-finite or missing fused training losses")
    if not epochs[1] < epochs[0]:
        raise SystemExit(f"fused epoch loss did not fall: {epochs}")

    # the unfused model from the same weights on the same data
    ref = SingleTrainer(ref_cfg, num_epoch=FUSED_EPOCHS, seed=seed,
                        **FUSED_TRAIN)
    ref.train(data, initial_variables=unfused_start)
    ref_epochs = ref.history["epoch_loss"]
    ref_loss = ref.step_metrics["loss"]
    print(f"fused: fusion='none' from the same weights: epoch_loss="
          f"{ref_epochs} step losses {np.round(ref_loss, 5).tolist()}; "
          f"first step loss diff {abs(loss[0] - ref_loss[0]):.6g}")

    # determinism: the same two steps twice from the same start
    tx = resolve_optimizer(FUSED_TRAIN["worker_optimizer"],
                           FUSED_TRAIN["learning_rate"])
    step = make_train_step(trainer.model, FUSED_TRAIN["loss"], tx)
    b = FUSED_TRAIN["batch_size"]
    batches = [{c: torch.from_numpy(data[c][i * b:(i + 1) * b]).to("cuda")
                for c in ("features", "label")} for i in range(2)]
    runs = []
    for _ in range(2):
        state = TrainState.create(trainer.model, start, tx, device="cuda")
        runs.append([float(step(state, bt)[1]["loss"]) for bt in batches])
        del state
    print(f"fused: two runs of steps 1-2 from one start: {runs[0]} and "
          f"{runs[1]}")
    if runs[0] != runs[1]:
        raise SystemExit("the fused training step is not deterministic")

    # step times, fused and unfused in turns on the trained weights
    ref_step = make_train_step(ref.model, FUSED_TRAIN["loss"], tx)
    fstate = TrainState.create(trainer.model, trainer.trained_variables, tx,
                               device="cuda")
    ustate = TrainState.create(ref.model, ref.trained_variables, tx,
                               device="cuda")
    times = {"pallas_block": [], "none": []}
    for name, st_, fn in (("pallas_block", fstate, step),
                          ("none", ustate, ref_step),
                          ("none", ustate, ref_step),
                          ("pallas_block", fstate, step)):
        times[name].append(_step_ms(fn, st_, batches[0], torch, np))
    step_ms = {k: float(np.mean([m for m, _ in v])) for k, v in times.items()}
    train_flops = 3.0 * fwd_flops * b
    res = {"steps": int(len(loss)), "epoch_loss": epochs,
           "step_loss": loss.tolist(), "launches_per_step": per_step,
           "input_copies": copies[0], "gradient_copies": copies[1],
           "none_epoch_loss": ref_epochs, "none_step_loss": ref_loss.tolist(),
           "determinism_losses": runs, "training_time_s":
           trainer.training_time, "step_ms": step_ms,
           "step_ms_runs": {k: [t for _, t in v] for k, v in times.items()},
           "images_per_s": {k: b / v * 1e3 for k, v in step_ms.items()},
           "mfu": {k: train_flops / (v / 1e3) / PEAK_FLOPS["bfloat16"]
                   for k, v in step_ms.items()},
           "conv_mix": {str(k): n for k, n in conv_mix.items()},
           "tail_mix": {str(k): n for k, n in tail_mix.items()}}
    print(f"fused: step_ms (median of steps 2-6, mean of 2 turns each) "
          f"{step_ms} images_per_s {res['images_per_s']} mfu {res['mfu']} "
          f"(analytic conv FLOPs x3 against 989 TFLOP/s)")
    del ustate, ref, ref_step
    torch.cuda.empty_cache()

    t0 = time.monotonic()
    for _ in range(2):
        step(fstate, batches[0])
    torch.cuda.synchronize()
    res["profile"] = _fused_profile(step, fstate, batches[0],
                                    time.monotonic() - t0, 2, torch)
    del fstate
    torch.cuda.empty_cache()

    # pallas_tail with fusion_stages, at smaller depth
    tail_cfg = model_config("resnet", (IMAGE, IMAGE, 3),
                            **{**FUSED, **TAIL_RUN})
    tail_tr = SingleTrainer(tail_cfg, num_epoch=1, seed=seed, **FUSED_TRAIN)
    names = tail_tr.model.block_names
    before, copies0 = _fb_counts(fb), fb.input_copies
    tail_tr.train(data.take(TAIL_ROWS))
    torch.cuda.synchronize()
    after = _fb_counts(fb)
    t_loss = tail_tr.step_metrics["loss"]
    t_steps = TAIL_ROWS // b
    n_fused = sum(n.startswith("Fused") for n in names)
    delta = {k: after[k] - before[k] for k in after}
    print(f"fused: pallas_tail fusion_stages={TAIL_RUN['fusion_stages']} "
          f"stages={TAIL_RUN['stage_sizes']} blocks={names} losses="
          f"{t_loss.tolist()} launches={delta} input_copies="
          f"{fb.input_copies - copies0}")
    if delta != {"conv1x1_gn_fwd": 0, "conv1x1_gn_bwd": 0,
                 "bottleneck_tail_fwd": n_fused * t_steps,
                 "bottleneck_tail_bwd": n_fused * t_steps} \
            or names != ["FusedBottleneckBlock_0", "FusedBottleneckBlock_1",
                         "BottleneckBlock_0", "BottleneckBlock_1"] \
            or not np.isfinite(t_loss).all():
        raise SystemExit("pallas_tail run: launches, block names or losses "
                         "off")
    res["pallas_tail"] = {"blocks": names, "losses": t_loss.tolist(),
                          "launches": delta}
    del tail_tr, trainer
    torch.cuda.empty_cache()

    batch0 = {c: torch.from_numpy(data[c][:FUSED_GRAD_BATCH]).to("cuda")
              for c in ("features", "label")}
    res["step1_grads"] = _fused_grads_agree(unfused_start, batch0, torch,
                                            np)
    res["phase_s"] = time.monotonic() - t_phase
    print(f"fused: phase took {res['phase_s']:.1f} s")
    return res, launches


# ---- phase 7: sequence-parallel LM training (ring attention, #3-#4) ---

# The JAX package's long-context row "L12 d768, T=8192 b4 (32k tokens)"
# (its PERF.md §19 at 3509981, run there with remat_blocks, which the
# port does not need on 80 GB), trained as examples/lm_seq_parallel.py
# trains it (adam, a step of make_train_step on lm_synth rows, the epoch
# order drawn from seed + epoch), with every attention layer a ring of 4
# (T_local 2048) through the hop kernels; widths not cut
SEQ_LM = dict(vocab_size=32768, num_layers=12, d_model=768, num_heads=12,
              mlp_ratio=4, max_len=8192, dtype="bfloat16")
SEQ_T, SEQ_RING, SEQ_BATCH, SEQ_ROWS, SEQ_EPOCHS = 8192, 4, 4, 16, 2
SEQ_LR = 3e-4
SEQ_DENSE_T = 2048                   # (e) ring against dense attention
HOP_SHAPE = (4, 12, 2048, 64)        # [B, H, T_local, D] of each hop
HOP_KERNELS = ("flash_hop_fwd", "flash_hop_bwd_dq", "flash_hop_bwd_dkv")
# (q block, k block, causal) as ring ranks: the diagonal hop, a past
# block, a future block (dead: nothing to do, the state passes), and a
# past block without the causal mask
HOPS = {"diagonal": (1, 1, True), "past": (3, 1, True),
        "dead": (1, 2, True), "full": (1, 0, False)}
# a ring of n runs n diagonal, n(n-1)/2 past and n(n-1)/2 dead hops per
# layer and direction
HOP_MIX = {"diagonal": SEQ_RING, "past": SEQ_RING * (SEQ_RING - 1) // 2,
           "dead": SEQ_RING * (SEQ_RING - 1) // 2}
# the hop checks' tolerances: acc, dq, dk, dv per element as the flash
# backward's (TOL_GRAD): each is an f32 sum over the block of products
# with a P or ds that the kernel and the plain version may round to
# neighbouring bf16 values (f32: summation order and expf); m to TOL_LSE
# absolute and l to TOL_LSE of itself: f32 statistics, summation order
# only; a dead hop passes the state and the carried sums bit for bit,
# and a carried sum takes the partial by one exact f32 add.
# (shape, hop, dtype) of the checks beside the path's [4,12,2048,64] ones
# (D 128 is where the backward kernels and their plain versions sum in
# different orders, so these cases are what test the dq, dk, dv limit;
# T_local 2000 puts the ring offsets and the diagonal off the 64-row
# tiles)
HOP_EXTRA = (((2, 4, 2048, 128), "past", "bfloat16"),
             ((4, 12, 2048, 128), "diagonal", "bfloat16"),
             ((4, 12, 2000, 128), "diagonal", "bfloat16"))
# device time by class on the sequence-parallel step
SEQ_CLASSES = (("hop_kernels", ("flash_hop::",)),
               ("products", KERNEL_CLASSES[3][1]))


def _hop_counts(attention):
    return {"flash_hop_fwd": attention.hop_fwd_launches,
            "flash_hop_bwd_dq": attention.hop_dq_launches,
            "flash_hop_bwd_dkv": attention.hop_dkv_launches}


def _reset_hops(attention):
    attention.hop_fwd_launches = 0
    attention.hop_dq_launches = 0
    attention.hop_dkv_launches = 0


def _hop_case(attention, torch, gen, shape, dtype, hop):
    """One hop's inputs as the ring makes them: the state the diagonal
    hop left (the initial state for the diagonal hop itself), and the
    backward's final lse and dsum = rowsum(dO.O) of that state."""
    b, h, t, d = shape
    qb, kb, causal = HOPS[hop]
    q, k, v, do, k0, v0 = (torch.randn(b, h, t, d, device="cuda",
                                       dtype=dtype, generator=gen)
                           for _ in range(6))
    kw = dict(q_offset=qb * t, k_offset=kb * t, scale=d ** -0.5,
              causal=causal)
    m = torch.full((b, h, t), -1e30, device="cuda")
    l = torch.zeros(b, h, t, device="cuda")
    acc = torch.zeros(b, h, t, d, device="cuda")
    if hop != "diagonal":
        m, l, acc = attention.flash_hop_fwd_reference(
            q, k0, v0, m, l, acc, q_offset=qb * t, k_offset=qb * t,
            scale=d ** -0.5, causal=True)
    fm, fl, facc = attention.flash_hop_fwd_reference(q, k, v, m, l, acc,
                                                     **kw)
    out = facc / fl.unsqueeze(-1)
    dsum = (do.float() * out).sum(-1)
    return (q, k, v, do, m, l, acc, fm + torch.log(fl), dsum), kw


def _check_hops(attention, torch):
    """(a) each hop kernel against its plain version on the card."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    cases = [(HOP_SHAPE, hop, dname) for dname in ("bfloat16", "float32")
             for hop in ("diagonal", "past", "dead")]
    cases += [(HOP_SHAPE, "full", "bfloat16")] + list(HOP_EXTRA)
    rows = []
    for shape, hop, dname in cases:
        (q, k, v, do, m, l, acc, lse, dsum), kw = _hop_case(
            attention, torch, gen, shape, getattr(torch, dname), hop)
        got = attention.flash_hop_fwd(q, k, v, m.clone(), l.clone(),
                                      acc.clone(), **kw)
        want = attention.flash_hop_fwd_reference(q, k, v, m, l, acc, **kw)
        args = (q, k, v, do, lse, dsum)
        grads = attention.flash_hop_bwd(*args, **kw)
        want_grads = (attention.flash_hop_bwd_dq_reference(*args, **kw),
                      *attention.flash_hop_bwd_dkv_reference(*args, **kw))
        # the path's form: partials added to carried f32 sums, in place
        carried = [torch.randn_like(g) for g in grads]
        summed = attention.flash_hop_bwd(
            *args, dq=carried[0].clone(), dk=carried[1].clone(),
            dv=carried[2].clone(), **kw)
        torch.cuda.synchronize()
        row = {"shape": list(shape), "dtype": dname, "hop": hop,
               "q_offset": kw["q_offset"], "k_offset": kw["k_offset"],
               "causal": kw["causal"],
               "m_err": (got[0] - want[0]).abs().max().item(),
               "l_rel_err": ((got[1] - want[1]).abs()
                             / want[1].abs().clamp_min(1e-30)).max().item()}
        ok = row["m_err"] <= TOL_LSE and row["l_rel_err"] <= TOL_LSE
        for name, a, w in zip(("acc", "dq", "dk", "dv"), (got[2],) + grads,
                              (want[2],) + want_grads):
            diff = (a - w).abs()
            rms = w.square().mean().sqrt()
            row[f"{name}_err"] = diff.max().item()
            row[f"{name}_ratio"] = ((diff / (w.abs() + rms)).max().item()
                                    if rms > 0 else diff.max().item())
            ok = (ok and row[f"{name}_ratio"] <= TOL_GRAD[dname]
                  and bool(torch.isfinite(a).all()))
        row["carry_exact"] = all(torch.equal(s, c + g) for s, c, g
                                 in zip(summed, carried, grads))
        ok = ok and row["carry_exact"]
        if hop == "dead":
            row["dead_bit_equal"] = all(
                torch.equal(a, w) for a, w in zip(got + grads,
                                                  (m, l, acc) + want_grads))
            ok = ok and row["dead_bit_equal"]
        row["ok"] = ok
        print(f"hop {row}")
        if not ok:
            raise SystemExit(f"a hop kernel disagrees with its plain "
                             f"version: {row}")
        rows.append(row)
    return rows


def _hop_flops(kernel, shape, hop):
    """Operations of one hop of ``kernel``: its products (2 forward, 3
    for dq, 4 for dk/dv) over the pairs the mask leaves."""
    b, h, t, d = shape
    pairs = {"diagonal": t * (t + 1) / 2, "past": t * t, "full": t * t,
             "dead": 0}[hop]
    products = {"flash_hop_fwd": 2, "flash_hop_bwd_dq": 3,
                "flash_hop_bwd_dkv": 4}[kernel]
    return 2 * products * b * h * pairs * d


def _hop_bound(kernel, shape, hop):
    """Least time (ms) and what bounds it for one hop of ``kernel`` at
    bf16: its products over the pairs the mask leaves (the kernels'
    own: 2 forward, 3 for dq, 4 for dk/dv, the split recomputing q.k^T
    and do.v^T), and its tensors read once and written once: q, k, v
    (and do, lse, dsum) read, the f32 state or carried sums read and
    written.  A dead hop has nothing to do: 0."""
    b, h, t, d = shape
    flops = _hop_flops(kernel, shape, hop)
    if not flops:
        return 0.0, "bytes"
    tensors, state = {"flash_hop_fwd": (3, 2 * d + 4),
                      "flash_hop_bwd_dq": (4, 2 * d),
                      "flash_hop_bwd_dkv": (4, 4 * d)}[kernel]
    nbytes = (tensors * b * h * t * d * 2 + b * h * t * state * 4
              + (2 * b * h * t * 4 if kernel != "flash_hop_fwd" else 0))
    t_ops, t_bytes = flops / PEAK_FLOPS["bfloat16"], nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _time_hops(attention, torch):
    """(b) each hop kernel per launch at the path's shape, bf16, by hop
    kind, against its bound, its plain version and the library
    yardstick: the flash kernel of SDPA on the same block (causal for
    the diagonal hop, full for a past one; it returns out and lse and
    merges no state), its backward for #4.  A dead hop has no library
    call to time: its ``library_ms`` is None."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    out = {}
    for hop in ("diagonal", "past", "dead"):
        (q, k, v, do, m, l, acc, lse, dsum), kw = _hop_case(
            attention, torch, gen, HOP_SHAPE, torch.bfloat16, hop)
        args = (q, k, v, do, lse, dsum)
        dq, dk, dv = (torch.zeros(q.shape, device="cuda") for _ in range(3))
        calls = {
            "flash_hop_fwd": (
                lambda: attention.flash_hop_fwd(q, k, v, m, l, acc, **kw),
                lambda: attention.flash_hop_fwd_reference(q, k, v, m, l,
                                                          acc, **kw)),
            "flash_hop_bwd_dq": (
                lambda: attention.flash_hop_bwd_dq(*args, dq=dq, **kw),
                lambda: attention.flash_hop_bwd_dq_reference(*args, dq=dq,
                                                             **kw)),
            "flash_hop_bwd_dkv": (
                lambda: attention.flash_hop_bwd_dkv(*args, dk=dk, dv=dv,
                                                    **kw),
                lambda: attention.flash_hop_bwd_dkv_reference(
                    *args, dk=dk, dv=dv, **kw))}
        lib = {"fwd": None, "bwd": None}
        if hop != "dead":
            causal = hop == "diagonal"
            sdpa = torch.ops.aten._scaled_dot_product_flash_attention
            lib["fwd"] = _time_ms(lambda: sdpa(q, k, v, 0.0, causal, False,
                                               scale=kw["scale"]), 10)
            ql, kl, vl = (x.detach().clone().requires_grad_()
                          for x in (q, k, v))
            res = sdpa(ql, kl, vl, 0.0, causal, False, scale=kw["scale"])
            lib["bwd"] = _profiled_ms(lambda: torch.autograd.grad(
                res[0], (ql, kl, vl), do, retain_graph=True), 10)
        for name, (kernel, plain) in calls.items():
            bound, by = _hop_bound(name, HOP_SHAPE, hop)
            row = {"ms": _time_ms(kernel, 20 if hop == "dead" else 5),
                   "plain_ms": _time_ms(plain, 3), "bound_ms": bound,
                   "bound_by": by,
                   "library_ms": lib["fwd" if name == "flash_hop_fwd"
                                     else "bwd"]}
            row["tflops"] = _tflops(_hop_flops(name, HOP_SHAPE, hop),
                                    row["ms"])
            out[(name, hop)] = row
            print(f"timing {name} {list(HOP_SHAPE)} bf16 {hop}: kernel "
                  f"{row['ms']:.4f} ms ({row['tflops']:.1f} TFLOP/s), "
                  f"plain {row['plain_ms']:.4f} ms, "
                  f"sdpa flash {row['library_ms']} ms, bound "
                  f"{bound:.5f} ms ({by})")
    return out


def _seq_profile(step, state, batches, wall, torch):
    """Two ring steps under ``torch.profiler``: device time by class
    and the idle share against the same steps' unprofiled ``wall``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for batch in batches:
            step(state, batch)
        torch.cuda.synchronize()
    kernels = _device_kernels(prof, torch)
    classes = {name: 0.0 for name, _ in SEQ_CLASSES}
    classes["elementwise_copies"] = 0.0
    for kname, ms in kernels.items():
        cls = next((name for name, marks in SEQ_CLASSES
                    if any(m in kname for m in marks)),
                   "elementwise_copies")
        classes[cls] += ms
    busy = sum(kernels.values())
    n = len(batches)
    per = {k: v / n for k, v in classes.items()}
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    res = {"steps": n, "wall_ms": wall * 1e3, "device_busy_ms": busy,
           "idle_share": 1 - busy / 1e3 / wall, "by_class_ms_per_step": per,
           "top_kernels_ms": dict(top)}
    print(f"seq profile: {n} steps, unprofiled {wall * 1e3:.3f} ms, device "
          f"busy {busy:.3f} ms, idle share {res['idle_share']:.4f}; per "
          f"step by class (ms): "
          + " ".join(f"{k}={v:.3f}" for k, v in per.items()))
    for name, ms in top:
        print(f"seq profile:   {ms / n:9.3f} ms/step  {name[:90]}")
    return res


def _seq_train(seed, torch, np):
    """(c)-(g): the sequence-parallel LM trains over InProcessRing(4);
    the flash_attn=True twin from the same start; the ring against
    dense attention at T 2048; determinism; step time and profile."""
    from distkeras_tpu_torch import build_model, convert
    from distkeras_tpu_torch.data import datasets
    from distkeras_tpu_torch.models import model_config
    from distkeras_tpu_torch.ops import attention
    from distkeras_tpu_torch.parallel import ring_attention as ring
    from distkeras_tpu_torch.workers import (TrainState, make_train_step,
                                             resolve_optimizer)

    t_phase = time.monotonic()
    loss_name = "sparse_categorical_crossentropy"

    def build(**over):
        return build_model(model_config("transformer_lm", (SEQ_T,),
                                        input_dtype="int32",
                                        **{**SEQ_LM, **over}))

    seq_model = build(seq_axis="seq",
                      attn_fn=ring.ring_attn_fn("seq", impl="flash"))
    n_params = sum(p.numel() for p in seq_model.parameters())
    start = convert.params_from_flax(
        _flax_tree(np.random.default_rng(seed + 3), SEQ_LM))
    data = datasets.lm_synth(SEQ_ROWS, seq_len=SEQ_T,
                             vocab_size=SEQ_LM["vocab_size"], seed=seed)
    batches = []
    for epoch in range(SEQ_EPOCHS):
        order = np.random.default_rng(seed + epoch).permutation(SEQ_ROWS)
        for s in range(SEQ_ROWS // SEQ_BATCH):
            rows = order[s * SEQ_BATCH:(s + 1) * SEQ_BATCH]
            batches.append({k: torch.from_numpy(data[k][rows]).cuda()
                            for k in ("features", "label")})
    tx = resolve_optimizer("adam", SEQ_LR)
    ring4 = ring.InProcessRing(SEQ_RING)

    def bound(fn):
        return ring.sequence_sharded_apply(fn, ring4, "seq",
                                           num_seq_args=0)

    step = bound(make_train_step(seq_model, loss_name, tx))
    state = TrainState.create(seq_model, start, tx, device="cuda")
    per_step = SEQ_RING ** 2 * SEQ_LM["num_layers"]

    # (c) train: counts set to 0 just before, read just after
    losses, gnorms, times = [], [], []
    torch.cuda.synchronize()
    _reset_hops(attention)
    _reset_counts(attention)
    for i, batch in enumerate(batches):
        t0 = time.monotonic()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.monotonic() - t0)
        losses.append(metrics["loss"].item())
        gnorms.append(metrics["grad_norm"].item())
        if i == 0:
            first = _hop_counts(attention)
    launches = _hop_counts(attention)
    flash_counts = _counts(attention)
    steps = len(batches)
    per_epoch = SEQ_ROWS // SEQ_BATCH
    epochs = [float(np.mean(losses[e * per_epoch:(e + 1) * per_epoch]))
              for e in range(SEQ_EPOCHS)]
    print(f"seq train: params={n_params} steps={steps} epoch_loss={epochs} "
          f"launches={launches} (step 1: {first}) device-local flash "
          f"launches={flash_counts}")
    print(f"seq train: step losses {np.round(losses, 4).tolist()}")
    print(f"seq train: grad norms {np.round(gnorms, 4).tolist()}")
    if any(n != per_step for n in first.values()) \
            or any(n != per_step * steps for n in launches.values()):
        raise SystemExit(f"hop kernel launches {launches} (step 1: "
                         f"{first}); expected {per_step} each a step")
    if any(flash_counts.values()):
        raise SystemExit(f"the ring path launched a device-local flash "
                         f"kernel: {flash_counts}")
    if not (np.isfinite(losses).all() and np.isfinite(gnorms).all()):
        raise SystemExit("non-finite ring training losses")
    if not epochs[1] < epochs[0]:
        raise SystemExit(f"ring epoch loss did not fall: {epochs}")

    # (d) the flash_attn=True twin (kernels #1-#2, no ring) from the
    # same start on the same first 3 batches
    flash_model = build(flash_attn=True)
    flash_step = make_train_step(flash_model, loss_name, tx)
    fstate = TrainState.create(flash_model, start, tx, device="cuda")
    hops_before = _hop_counts(attention)
    flash_losses, flash_gnorms = [], []
    for batch in batches[:3]:
        fstate, metrics = flash_step(fstate, batch)
        flash_losses.append(metrics["loss"].item())
        flash_gnorms.append(metrics["grad_norm"].item())
    del fstate
    flash_gnorm = flash_gnorms[0]
    if _hop_counts(attention) != hops_before:
        raise SystemExit("the flash_attn=True twin launched a hop kernel")
    diff = np.abs(np.array(flash_losses) - losses[:3])
    gdiff = abs(flash_gnorm / gnorms[0] - 1)
    print(f"seq train: flash_attn=True first 3 losses {flash_losses} vs "
          f"ring {losses[:3]}: max |diff| {diff.max():.6g} (tolerance "
          f"{TOL_TRAIN_LOSS}); step 1 grad_norm {flash_gnorm:.6g} vs "
          f"{gnorms[0]:.6g}: relative diff {gdiff:.6g} (tolerance "
          f"{TOL_TRAIN_GNORM})")
    if not diff.max() <= TOL_TRAIN_LOSS:
        raise SystemExit("ring and flash_attn=True losses disagree")
    if not gdiff <= TOL_TRAIN_GNORM:
        raise SystemExit("ring and flash_attn=True step-1 gradient norms "
                         "disagree")
    flash_err = bound(lambda _: _first_grads_agree(
        seq_model, flash_model, start, batches[0], loss_name, torch,
        "ring against flash_attn=True"))(None)
    del flash_model
    torch.cuda.empty_cache()

    # (e) the ring against dense attention at T 2048 (T_local 512)
    short = {k: v[:, :SEQ_DENSE_T].contiguous()
             for k, v in batches[0].items()}
    dense_model = build(attn="dense")
    dense_err = bound(lambda _: _first_grads_agree(
        seq_model, dense_model, start, short, loss_name, torch,
        f"ring against dense attention at T {SEQ_DENSE_T}"))(None)
    del dense_model
    torch.cuda.empty_cache()

    # (f) two runs of two ring steps from one start: the same bits
    def two_steps():
        st = TrainState.create(seq_model, start, tx, device="cuda")
        return [step(st, b)[1]["loss"].item() for b in batches[:2]]

    runs = [two_steps(), two_steps()]
    print(f"seq train: determinism, two runs of two steps: {runs}")
    if runs[0] != runs[1]:
        raise SystemExit(f"ring training is not deterministic: {runs}")

    # (g) step time (median of steps 2-6 of (c)), rates, profile of two
    # further steps against the unprofiled wall of (c)'s last two
    step_s = float(np.median(times[1:6]))
    tokens = SEQ_BATCH * SEQ_T
    f_param, f_attn = _lm_flops(SEQ_LM, n_params, SEQ_BATCH)
    peak = PEAK_FLOPS["bfloat16"]
    res = {"params": n_params, "steps": steps, "epoch_loss": epochs,
           "step_loss": losses, "grad_norm": gnorms,
           "launches_per_step": first, "launches": launches,
           "flash_first_losses": flash_losses,
           "flash_max_abs_diff": float(diff.max()),
           "flash_grad_norm_rel_diff": float(gdiff),
           "step1_grad_rel_err_vs_flash": flash_err,
           "step1_grad_rel_err_vs_dense_t2048": dense_err,
           "determinism_losses": runs,
           "step_ms": step_s * 1e3, "step_ms_all": [x * 1e3 for x in times],
           "tokens_per_s": tokens / step_s,
           "mfu_6nd": f_param / step_s / peak,
           "mfu_with_attn": (f_param + f_attn) / step_s / peak}
    print(f"seq train: step_ms={res['step_ms']:.3f} (median of steps 2-6; "
          f"all {np.round(res['step_ms_all'], 3).tolist()}) tokens_per_s="
          f"{res['tokens_per_s']:.1f} mfu_6nd={res['mfu_6nd']:.4f} "
          f"mfu_with_attn={res['mfu_with_attn']:.4f} (against 989 TFLOP/s)")
    res["profile"] = _seq_profile(step, state, batches[-2:],
                                  sum(times[-2:]), torch)
    res["phase_s"] = time.monotonic() - t_phase
    print(f"seq train: phase took {res['phase_s']:.1f} s")
    return res, launches


# ---- phase 8: the rest of the Trainer family ---------------------------

# (a) SyncTrainer on phase 6's fused path: 4 workers of 64 rows, the
# global batch of 256 on the card, 2 epochs of 2 steps, against
# SingleTrainer at batch 256 from the same weights on the same rows
SYNC = dict(num_workers=4, batch_size=64)
SYNC_ROWS, SYNC_EPOCHS = 512, 2
# (b) AveragingTrainer on phase 5's model (norm="group_pallas"): 2
# members of batch 32, 1 epoch of 2 steps each (shards of 64 rows); then
# one step of each EnsembleTrainer member (shards of 32 rows)
MEMBERS, MEMBER_BATCH, MEMBER_ROWS = 2, 32, 128
# (c) BatchNorm through the PS round: ADAG (faithful) over ResNet-50
# with norm="batch", 2 workers, window 2, batch 32, 1 epoch of 2 rounds,
# lr 0.05 scaled by ADAG's law (lr_law="scale") as phase 5's
BN_RESNET = {**RESNET, "norm": "batch"}
BN_PS = {**PS, "num_workers": 2}
BN_ROWS = 256
# (d) dropout on the card: the MNIST baseline MLP (784 -> 500 -> 500 ->
# 10) at dropout_rate 0.3 through EnsembleTrainer, 2 members of batch 64,
# 1 epoch of 4 steps each, adam 1e-3
DROP_MLP = dict(num_classes=10, hidden=(500, 500), dropout_rate=0.3)
DROP_ROWS, DROP_BATCH = 512, 64


def _trainer_family(seed, torch, np, fb, gn):
    """Phase 8: (a) SyncTrainer against SingleTrainer on the fused path,
    (b) AveragingTrainer and EnsembleTrainer on the GroupNorm kernels,
    (c) BatchNorm's worker-local statistics through ADAG, (d) dropout's
    per-member streams.  Returns the numbers and each path's launch
    counts (set to 0 just before the path, read just after)."""
    from distkeras_tpu_torch import (ADAG, AveragingTrainer,
                                     EnsembleTrainer, SingleTrainer,
                                     SyncTrainer)
    from distkeras_tpu_torch.data import datasets
    from distkeras_tpu_torch.models import model_config
    from distkeras_tpu_torch.workers import make_train_step

    t_phase = time.monotonic()
    res, counts = {}, {}
    t0 = time.monotonic()
    data = datasets.imagenet_synth(SYNC_ROWS, image_size=IMAGE,
                                   num_classes=FUSED["num_classes"],
                                   seed=seed)
    print(f"trainers: imagenet_synth({SYNC_ROWS}) made in "
          f"{time.monotonic() - t0:.1f} s")

    # (a) SyncTrainer and SingleTrainer in turns from the same weights:
    # sync, single, single, sync; the kernels counted on the first run
    cfg = model_config("resnet", (IMAGE, IMAGE, 3), **FUSED)
    train = {**FUSED_TRAIN, "num_epoch": SYNC_EPOCHS, "seed": seed}
    steps = SYNC_EPOCHS * (SYNC_ROWS // FUSED_TRAIN["batch_size"])
    runs = {"sync": [], "single": []}
    start = None
    for turn, name in enumerate(("sync", "single", "single", "sync")):
        if name == "sync":
            tr = SyncTrainer(cfg, num_workers=SYNC["num_workers"],
                             **{**train, "batch_size": SYNC["batch_size"]})
        else:
            tr = SingleTrainer(cfg, **train)
        if start is None:
            start = {k: v.clone() for k, v in tr.model.state_dict().items()}
        torch.cuda.synchronize()
        if turn == 0:
            _reset_fb(fb)
        tr.train(data, initial_variables=start)
        torch.cuda.synchronize()
        if turn == 0:
            counts["sync_train"] = _fb_counts(fb)
        runs[name].append((tr.step_metrics["loss"], tr.training_time,
                           tr.history["epoch_loss"]))
        del tr
        torch.cuda.empty_cache()
    blocks = sum(FUSED["stage_sizes"])
    convs = blocks + len(FUSED["stage_sizes"])
    want = {k: n * steps for k, n in zip(FB_KERNELS, (convs, convs, blocks,
                                                      blocks))}
    sync_loss = runs["sync"][0][0]
    step_ms = {k: float(np.mean([t for _, t, _ in v])) / steps * 1e3
               for k, v in runs.items()}
    print(f"trainers: SyncTrainer(num_workers={SYNC['num_workers']}, "
          f"batch_size={SYNC['batch_size']}) fused steps={len(sync_loss)} "
          f"losses {sync_loss.tolist()} epoch_loss {runs['sync'][0][2]} "
          f"launches={counts['sync_train']} (want {want}); "
          f"SingleTrainer(batch_size={FUSED_TRAIN['batch_size']}) losses "
          f"{runs['single'][0][0].tolist()}; trainer ms a step (training "
          f"time over {steps} steps, mean of 2 turns) {step_ms}")
    if counts["sync_train"] != want:
        raise SystemExit(f"SyncTrainer's fused kernel launches "
                         f"{counts['sync_train']}; expected {want}")
    if len(sync_loss) != steps or not np.isfinite(sync_loss).all():
        raise SystemExit("SyncTrainer's losses missing or not finite")
    if not all(np.array_equal(loss, sync_loss)
               for v in runs.values() for loss, _, _ in v):
        raise SystemExit("SyncTrainer(4 x 64) and SingleTrainer(256) "
                         "losses are not bit-equal")
    res["sync"] = {"steps": steps, "losses": sync_loss.tolist(),
                   "single_losses": runs["single"][0][0].tolist(),
                   "launches": counts["sync_train"],
                   "trainer_step_ms": step_ms,
                   "training_time_s": {k: [t for _, t, _ in v]
                                       for k, v in runs.items()}}

    # (b) AveragingTrainer over the GroupNorm kernels
    cfg = model_config("resnet", (IMAGE, IMAGE, 3), **RESNET)
    member = dict(batch_size=MEMBER_BATCH, seed=seed, learning_rate=PS_LR,
                  worker_optimizer="momentum",
                  loss="sparse_categorical_crossentropy")
    avg = AveragingTrainer(cfg, num_workers=MEMBERS, num_epoch=1, **member)
    rows = data.take(MEMBER_ROWS)
    torch.cuda.synchronize()
    _reset_gn(gn)
    avg.train(rows)
    torch.cuda.synchronize()
    counts["averaging_train"] = _gn_counts(gn)
    routes = {"averaging_train": dict(gn.route_launches)}
    member_steps = MEMBERS * (MEMBER_ROWS // MEMBERS // MEMBER_BATCH)
    per_step = sum(_resnet_shapes(avg.model, MEMBER_BATCH, torch)[0]
                   .values())
    want = per_step * member_steps
    av = avg.trained_variables
    mean_ok = all(torch.equal(av[k], torch.stack(
        [m[k] for m in avg.member_variables]).mean(0))
        for k, _ in avg.model.named_parameters())
    print(f"trainers: AveragingTrainer members={MEMBERS} member_loss="
          f"{avg.history['member_loss']} launches="
          f"{counts['averaging_train']} by route "
          f"{routes['averaging_train']} (want {want} of each: {per_step} a "
          f"step x {member_steps} member steps) mean of members: {mean_ok}"
          f" training_time_s={avg.training_time:.3f}")
    if any(n != want for n in counts["averaging_train"].values()) \
            or routes["averaging_train"] != {
                "fwd_one_pass": want, "fwd_two_pass": 0,
                "bwd_one_pass": want, "bwd_two_pass": 0}:
        raise SystemExit("AveragingTrainer's GroupNorm launches or routes "
                         "off")
    if not mean_ok or not np.isfinite(avg.history["member_loss"]).all():
        raise SystemExit("AveragingTrainer's result is not the members' "
                         "mean, or its losses are not finite")
    res["averaging"] = {"member_loss": avg.history["member_loss"],
                        "launches": counts["averaging_train"],
                        "routes": routes["averaging_train"],
                        "member_step_ms": avg.training_time / member_steps
                        * 1e3}
    del avg
    torch.cuda.empty_cache()
    # one step of each EnsembleTrainer member: distinct inits
    ens = EnsembleTrainer(cfg, num_models=MEMBERS, num_epoch=1, **member)
    torch.cuda.synchronize()
    _reset_gn(gn)
    members = ens.train(data.take(MEMBERS * MEMBER_BATCH))
    torch.cuda.synchronize()
    counts["ensemble_train"] = _gn_counts(gn)
    routes["ensemble_train"] = dict(gn.route_launches)
    differ = [k for k in members[0]
              if not torch.equal(members[0][k], members[1][k])]
    print(f"trainers: EnsembleTrainer one step a member: member_loss="
          f"{ens.history['member_loss']} launches={counts['ensemble_train']}"
          f" leaves that differ between members {len(differ)} of "
          f"{len(members[0])}")
    if any(n != per_step * MEMBERS
           for n in counts["ensemble_train"].values()) or not differ \
            or not np.isfinite(ens.history["member_loss"]).all():
        raise SystemExit("EnsembleTrainer's launches off, its members "
                         "equal, or its losses not finite")
    res["ensemble"] = {"member_loss": ens.history["member_loss"],
                       "launches": counts["ensemble_train"],
                       "leaves_differing": len(differ)}
    del ens, members
    torch.cuda.empty_cache()

    # (c) BatchNorm's statistics stay with each worker through ADAG
    cfg = model_config("resnet", (IMAGE, IMAGE, 3), **BN_RESNET)
    bn = ADAG(cfg, num_epoch=1, seed=seed, learning_rate=PS_LR,
              lr_law="scale", device="cuda", **BN_PS)
    start_stats = {k: v.clone() for k, v in bn.model.state_dict().items()
                   if k.endswith((".mean", ".var"))}
    bv = bn.train(data.take(BN_ROWS))
    torch.cuda.synchronize()
    losses = bn.history["round_loss"]
    w0, w1 = bn.worker_model_states
    moved = all(not torch.equal(w[k], start_stats[k])
                for w in (w0, w1) for k in start_stats)
    apart = all(not torch.equal(w0[k], w1[k]) for k in start_stats)
    returned = all(torch.equal(bv[k], w0[k]) for k in start_stats)
    round_ms = bn.epoch_time_s[0] / len(losses) * 1e3
    print(f"trainers: ADAG norm='batch' workers={BN_PS['num_workers']} "
          f"rounds={len(losses)} round_loss={losses} statistics "
          f"{len(start_stats)}: moved {moved}, apart {apart}, returned "
          f"worker 0's {returned}; round_ms={round_ms:.3f} (epoch 1 wall, "
          f"its shuffle included, over its rounds)")
    if not (len(losses) == 2 and np.isfinite(losses).all() and moved
            and apart and returned):
        raise SystemExit("ADAG with norm='batch': losses, or the workers' "
                         "statistics, off")
    res["batchnorm_ps"] = {"round_loss": losses, "round_ms": round_ms,
                           "statistics": len(start_stats)}
    del bn, bv, w0, w1
    torch.cuda.empty_cache()

    # (d) dropout: each member its own stream, a rerun bit-equal
    cfg = model_config("mlp", (784,), **DROP_MLP)
    drop_data = datasets.synthetic_classification(DROP_ROWS, (784,), 10,
                                                  seed=seed)
    drop = dict(num_models=MEMBERS, batch_size=DROP_BATCH, num_epoch=1,
                seed=seed, learning_rate=1e-3, worker_optimizer="adam",
                loss="sparse_categorical_crossentropy")
    reruns = []
    for _ in range(2):
        ens = EnsembleTrainer(cfg, **drop)
        reruns.append((ens.train(drop_data), ens.history["member_loss"]))
    bit_equal = reruns[0][1] == reruns[1][1] and all(
        torch.equal(a[k], b[k]) for a, b in zip(reruns[0][0], reruns[1][0])
        for k in a)
    # one step of each member from one start on one batch: the masks
    step = make_train_step(ens.model, drop["loss"], ens._tx())
    batch = {c: torch.from_numpy(drop_data[c][:DROP_BATCH]).to("cuda")
             for c in ("features", "label")}
    mask_losses = [float(step(s, batch)[1]["loss"])
                   for s in ens._member_states(ens.model.state_dict())]
    print(f"trainers: dropout MLP EnsembleTrainer member_loss="
          f"{reruns[0][1]} rerun bit-equal {bit_equal}; one step of each "
          f"member from one start on one batch: losses {mask_losses}")
    if not bit_equal or len(set(mask_losses)) != MEMBERS \
            or not np.isfinite(reruns[0][1]).all():
        raise SystemExit("dropout: members draw one mask, or a rerun "
                         "differs")
    res["dropout"] = {"member_loss": reruns[0][1],
                      "mask_step_losses": mask_losses}
    res["phase_s"] = time.monotonic() - t_phase
    print(f"trainers: phase took {res['phase_s']:.1f} s")
    return res, counts, routes


# ---- phase 9: checkpoints, kill-and-resume, evaluation, prediction ----

# (a) ADAG on phase 5's model and round (ResNet-50, norm="group_pallas",
# kernels #5-#6), cut to 2 workers and 384 rows: 3 rounds an epoch of 2
# workers x window 2 x batch 32, 2 epochs, a save every 2 rounds; the
# run is stopped just after the save at round 2 of the second epoch
CKPT_PS = {**PS, "num_workers": 2}
CKPT_PS_ROWS, CKPT_EVERY = 384, 2
CKPT_PS_STOP = {"epoch": 1, "round": 2}
# (b) SingleTrainer on phase 6's fused path (#7-#10): 2 epochs of 2 steps
# of 256, stopped after the first epoch's save
CKPT_FUSED_ROWS = 512
CKPT_FUSED_STOP = {"epoch": 1}
# (c) the holdout both runs evaluate after every epoch and the predictor
# scores: 300 rows, a ragged tail of 44 at batch 256
HOLDOUT_ROWS, PREDICT_BATCH = 300, 256
# the predictor's logits against the plain versions' forward on the same
# model: per element scaled by |plain| + rms(plain), as the fused
# kernels' rounded outputs are held (TOL_FB_ROUNDED)
TOL_PREDICT = TOL_FB_ROUNDED["bfloat16"]
# the least share of holdout rows whose class (argmax) the predictor and
# the plain versions' forward agree on; the rest are near-ties that the
# bf16 kernels' rounding may flip
EVAL_AGREE = 0.9


class _Stop(Exception):
    """Raised right after a save: a run killed there."""


def _same_tree(a, b, np) -> bool:
    """Equal trees, leaves of one dtype and equal bits."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and set(a) == set(b)
                and all(_same_tree(a[k], b[k], np) for k in a))
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and bool(
        np.array_equal(a, b))


def _watch_saves(trainer, stop, torch, np):
    """Wrap ``trainer._maybe_save`` as the reference's test does: time
    each save and the card memory it takes beyond the run's, read the
    file back against the state it holds, and stop
    the run (``_Stop``) right after the save at the cursor ``stop``."""
    from distkeras_tpu_torch import checkpoint, serialization

    orig, saves = trainer._maybe_save, []

    def saving(state, cursor):
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        orig(state, cursor)
        seconds = time.monotonic() - t0
        # the most card memory the save took beyond what the run held
        extra = torch.cuda.max_memory_allocated() - held
        path = checkpoint.checkpoint_file(trainer.checkpoint_dir)
        want = serialization.to_host(trainer._to_checkpoint(state)[0])
        same = _same_tree(want, checkpoint.load_checkpoint(path)[0], np)
        saves.append({"cursor": dict(cursor), "bytes": path.stat().st_size,
                      "s": seconds, "device_extra_bytes": extra,
                      "read_back_equal": same})
        if not same:
            raise SystemExit(f"checkpoint at {cursor} does not read back "
                             f"equal to the state it saved")
        if cursor == stop:
            raise _Stop

    trainer._maybe_save = saving
    return saves


def _watch_loads(trainer, torch):
    """Time ``trainer._maybe_resume`` (read, decode, copy to the card)."""
    from distkeras_tpu_torch import checkpoint

    orig, loads = trainer._maybe_resume, []

    def resume(resume_from, state):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        out = orig(resume_from, state)
        torch.cuda.synchronize()
        loads.append({"bytes": checkpoint.checkpoint_file(resume_from)
                      .stat().st_size, "s": time.monotonic() - t0})
        return out

    trainer._maybe_resume = resume
    return loads


def _kill_and_resume(make, data, holdout, stop, ckpt_dir, reset, read,
                     torch, np):
    """The uninterrupted run (its kernels counted: ``reset`` just before,
    ``read`` just after), a run stopped after the save at ``stop``, and a
    resume from that save, all three from the first one's initial
    weights; each evaluates ``holdout`` every epoch."""
    full = make()
    start = {k: v.clone() for k, v in full.model.state_dict().items()}
    torch.cuda.synchronize()
    reset()
    full.train(data, initial_variables=start, eval_dataset=holdout)
    torch.cuda.synchronize()
    counts = read()
    part = make(checkpoint_dir=str(ckpt_dir))
    saves = _watch_saves(part, stop, torch, np)
    try:
        part.train(data, initial_variables=start, eval_dataset=holdout)
        raise SystemExit(f"the run was not stopped at {stop}")
    except _Stop:
        pass
    del part
    resumed = make()
    loads = _watch_loads(resumed, torch)
    resumed.train(data, initial_variables=start, eval_dataset=holdout,
                  resume_from=str(ckpt_dir))
    torch.cuda.synchronize()
    return full, resumed, counts, saves, loads


def _eval_forwards(batch_size):
    """The holdout's forwards over 2 epochs: the trainers evaluate at
    batch ``max(batch_size, 256)``."""
    return 2 * -(-HOLDOUT_ROWS // max(batch_size, 256))


def _hist(trainer, keys):
    return {k: trainer.history.get(k) for k in keys}


def _checkpoint_phase(seed, torch, np, fb, gn):
    """Phase 9: (a) ADAG kill-and-resume on #5-#6, (b) SingleTrainer
    kill-and-resume on #7-#10, each with ``eval_dataset``, (c) the
    predictor over #7 and #9 against the plain versions' forward, and
    the evaluators, (d) the files read back.  Returns the numbers and
    each path's launch counts (set to 0 just before the path, read just
    after)."""
    import shutil
    import tempfile

    from distkeras_tpu_torch import (ADAG, SingleTrainer, checkpoint,
                                     convert, serialization, utils)
    from distkeras_tpu_torch.data import datasets
    from distkeras_tpu_torch.evaluators import (AccuracyEvaluator,
                                                evaluate_model)
    from distkeras_tpu_torch.models import model_config
    from distkeras_tpu_torch.predictors import ModelPredictor

    t_phase = time.monotonic()
    res, counts = {}, {}
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_"))
    try:
        holdout = datasets.imagenet_synth(HOLDOUT_ROWS, image_size=IMAGE,
                                          num_classes=1000, seed=seed + 1)
        data = datasets.imagenet_synth(CKPT_FUSED_ROWS, image_size=IMAGE,
                                       num_classes=1000, seed=seed)

        # (a) ADAG, faithful, on the GroupNorm kernels
        cfg = model_config("resnet", (IMAGE, IMAGE, 3), **RESNET)
        ps_kw = dict(num_epoch=2, seed=seed, learning_rate=PS_LR,
                     lr_law="scale", device="cuda",
                     checkpoint_every_rounds=CKPT_EVERY, **CKPT_PS)
        full, resumed, counts["ckpt_ps"], saves, loads = _kill_and_resume(
            lambda **kw: ADAG(cfg, **ps_kw, **kw),
            data.take(CKPT_PS_ROWS), holdout, CKPT_PS_STOP, tmp / "ps",
            lambda: _reset_gn(gn), lambda: _gn_counts(gn), torch, np)
        keys = ("round_loss", "epoch_loss", "dropped_tail_batches",
                "staleness", "eval_accuracy")
        rounds = len(full.history["round_loss"])
        steps = (rounds * CKPT_PS["num_workers"]
                 * CKPT_PS["communication_window"])
        per_step = sum(_resnet_shapes(full.model, CKPT_PS["batch_size"],
                                      torch)[0].values())
        evals = _eval_forwards(CKPT_PS["batch_size"])
        want = {"group_norm_fwd": per_step * (steps + evals),
                "group_norm_bwd": per_step * steps}
        center_equal = all(torch.equal(full.trained_variables[k],
                                       resumed.trained_variables[k])
                           for k in full.trained_variables)
        w0_equal = all(torch.equal(a, resumed.worker_model_states[0][k])
                       for k, a in full.worker_model_states[0].items())
        hist_equal = _hist(full, keys) == _hist(resumed, keys)
        print(f"checkpoint: ADAG norm='group_pallas' workers="
              f"{CKPT_PS['num_workers']} rounds={rounds} round_loss="
              f"{full.history['round_loss']} eval_accuracy="
              f"{full.history['eval_accuracy']} launches="
              f"{counts['ckpt_ps']} (want {want}); stopped at "
              f"{saves[-1]['cursor']} after saves {saves}; resumed: loads "
              f"{loads}, center bit-equal {center_equal}, worker 0's model "
              f"state bit-equal {w0_equal}, history {keys} equal "
              f"{hist_equal}")
        if counts["ckpt_ps"] != want:
            raise SystemExit("checkpoint phase: ADAG's GroupNorm launches "
                             "off")
        if not (center_equal and w0_equal and hist_equal):
            raise SystemExit("the resumed ADAG run differs from the "
                             "uninterrupted one")
        if len(full.history["eval_accuracy"]) != 2 \
                or not np.isfinite(full.history["round_loss"]).all():
            raise SystemExit("ADAG: eval_accuracy not once per epoch, or "
                             "losses not finite")
        # a PS snapshot of the trained center, read back
        snap = {"center": convert.params_tree(
                    full.parameter_server_state.center),
                "num_commits": int(full.parameter_server_state.clock),
                "last_reply": {}, "epoch": 0}
        torch.cuda.synchronize()
        t0 = time.monotonic()
        path = checkpoint.save_ps_snapshot(tmp / "ps.snap", snap)
        snap_s = time.monotonic() - t0
        t0 = time.monotonic()
        center = checkpoint.ps_snapshot_center(path)
        snap_load_s = time.monotonic() - t0
        info = checkpoint.ps_snapshot_info(path)
        snap_ok = _same_tree(serialization.to_host(snap["center"]), center,
                             np) and info["num_commits"] == \
            snap["num_commits"]
        print(f"checkpoint: PS snapshot {Path(path).stat().st_size} bytes "
              f"saved in {snap_s:.3f} s, read in {snap_load_s:.3f} s, "
              f"center bit-equal and info {info}: {snap_ok}")
        if not snap_ok:
            raise SystemExit("the PS snapshot does not read back equal")
        res["ps"] = {"rounds": rounds, "round_loss": full.history[
                         "round_loss"],
                     "eval_accuracy": full.history["eval_accuracy"],
                     "launches": counts["ckpt_ps"], "saves": saves,
                     "loads": loads, "snapshot": {
                         "bytes": Path(path).stat().st_size, "save_s":
                         snap_s, "load_s": snap_load_s}}
        del full, resumed
        shutil.rmtree(tmp / "ps", ignore_errors=True)
        torch.cuda.empty_cache()

        # (b) SingleTrainer on the fused path, from one start
        cfg = model_config("resnet", (IMAGE, IMAGE, 3), **FUSED)
        train = {**FUSED_TRAIN, "num_epoch": 2, "seed": seed}
        full, resumed, counts["ckpt_single"], saves, loads = \
            _kill_and_resume(lambda **kw: SingleTrainer(cfg, **train, **kw),
                             data, holdout, CKPT_FUSED_STOP,
                             tmp / "single", lambda: _reset_fb(fb),
                             lambda: _fb_counts(fb), torch, np)
        blocks = sum(FUSED["stage_sizes"])
        convs = blocks + len(FUSED["stage_sizes"])
        steps = 2 * CKPT_FUSED_ROWS // FUSED_TRAIN["batch_size"]
        fwd = steps + _eval_forwards(FUSED_TRAIN["batch_size"])
        want = dict(zip(FB_KERNELS, (convs * fwd, convs * steps,
                                     blocks * fwd, blocks * steps)))
        variables = resumed.trained_variables
        result_equal = all(torch.equal(full.trained_variables[k],
                                       variables[k])
                           for k in full.trained_variables)
        keys = ("epoch_loss", "eval_accuracy")
        hist_equal = _hist(full, keys) == _hist(resumed, keys)
        print(f"checkpoint: SingleTrainer fused steps={steps} epoch_loss="
              f"{full.history['epoch_loss']} eval_accuracy="
              f"{full.history['eval_accuracy']} launches="
              f"{counts['ckpt_single']} (want {want}); saves {saves}; "
              f"loads {loads}; result bit-equal {result_equal}, history "
              f"{keys} equal {hist_equal}")
        if counts["ckpt_single"] != want:
            raise SystemExit("checkpoint phase: the fused launches off")
        if not (result_equal and hist_equal):
            raise SystemExit("the resumed SingleTrainer differs from the "
                             "uninterrupted one")
        if len(full.history["eval_accuracy"]) != 2:
            raise SystemExit("SingleTrainer: eval_accuracy not once per "
                             "epoch")
        res["single"] = {"steps": steps,
                         "epoch_loss": full.history["epoch_loss"],
                         "eval_accuracy": full.history["eval_accuracy"],
                         "launches": counts["ckpt_single"],
                         "saves": saves, "loads": loads}
        del full, resumed
        shutil.rmtree(tmp / "single", ignore_errors=True)
        torch.cuda.empty_cache()

        # parameters through serialize_params and back
        torch.cuda.synchronize()
        t0 = time.monotonic()
        blob = utils.serialize_params(variables)
        ser_s = time.monotonic() - t0
        t0 = time.monotonic()
        back = utils.deserialize_params(variables, blob)
        torch.cuda.synchronize()
        de_s = time.monotonic() - t0
        params_ok = back.keys() == variables.keys() and all(
            torch.equal(back[k], variables[k]) for k in back)
        print(f"checkpoint: serialize_params {len(blob)} bytes in "
              f"{ser_s:.3f} s, deserialize_params in {de_s:.3f} s, "
              f"round trip bit-equal {params_ok}")
        if not params_ok:
            raise SystemExit("serialize_params/deserialize_params do not "
                             "round-trip")
        res["params"] = {"bytes": len(blob), "serialize_s": ser_s,
                         "deserialize_s": de_s}
        del back, blob

        # (c) the predictor through #7 and #9, the plain versions' forward
        # on the same model, the evaluators
        predictor = ModelPredictor(cfg, variables,
                                   batch_size=PREDICT_BATCH)
        torch.cuda.synchronize()
        _reset_fb(fb)
        scored = predictor.predict(holdout)
        counts["predict"] = _fb_counts(fb)
        batches = -(-HOLDOUT_ROWS // PREDICT_BATCH)
        want = dict(zip(FB_KERNELS, (convs * batches, 0, blocks * batches,
                                     0)))
        times = []
        for _ in range(3):
            t0 = time.monotonic()
            predictor.predict(holdout)
            times.append(time.monotonic() - t0)
        images_per_s = HOLDOUT_ROWS / float(np.median(times))
        plain_on = fb._on
        fb._on = lambda device, kernel, reference: reference
        try:
            plain = predictor.predict(holdout)["prediction"]
        finally:
            fb._on = plain_on
        logits = scored["prediction"]
        ratio = _ratio(torch.from_numpy(logits), torch.from_numpy(plain))
        # the holdout relabelled with the plain forward's classes: a right
        # evaluator reads near 1, one that misaligns rows or columns near
        # 1/1000
        labels = np.argmax(plain, axis=-1).astype(holdout["label"].dtype)
        by_eval = evaluate_model(predictor.model, variables,
                                 holdout.with_column("label", labels),
                                 batch_size=PREDICT_BATCH)["accuracy"]
        by_acc = AccuracyEvaluator().evaluate(
            scored.with_column("label", labels))
        by_numpy = float(np.mean(np.argmax(logits, axis=-1) == labels))
        print(f"checkpoint: ModelPredictor {HOLDOUT_ROWS} rows at batch "
              f"{PREDICT_BATCH}: logits {logits.shape} launches "
              f"{counts['predict']} (want {want}); against the plain "
              f"versions' forward: max ratio {ratio:.4g} (tolerance "
              f"{TOL_PREDICT}); images_per_s {images_per_s:.1f} (median "
              f"of {len(times)} calls, {times}); on the plain forward's "
              f"classes: evaluate_model accuracy {by_eval} "
              f"AccuracyEvaluator {by_acc} numpy argmax {by_numpy}")
        if counts["predict"] != want or logits.shape != (HOLDOUT_ROWS, 1000):
            raise SystemExit("the predictor's launches or shape off")
        if not (np.isfinite(logits).all() and ratio <= TOL_PREDICT):
            raise SystemExit("the predictor's logits disagree with the "
                             "plain versions' forward")
        if by_eval != by_acc or abs(by_acc - by_numpy) > 1e-6 \
                or by_acc < EVAL_AGREE:
            raise SystemExit("evaluate_model, AccuracyEvaluator and the "
                             "numpy argmax differ, or the fused and plain "
                             "forwards' classes disagree")
        res["predict"] = {"rows": HOLDOUT_ROWS, "batch": PREDICT_BATCH,
                          "launches": counts["predict"],
                          "max_ratio": ratio, "images_per_s": images_per_s,
                          "call_s": times,
                          "accuracy_on_plain_classes": by_eval}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    res["phase_s"] = time.monotonic() - t_phase
    print(f"checkpoint: phase took {res['phase_s']:.1f} s")
    return res, counts


# ---- phase 10: the host-wire parameter server (fidelity="host") -------

# phase 5's model and round (ResNet-50, norm="group_pallas", #5-#6, ADAG
# at lr_law="scale", window 2, batch 32) on the host arm: free-running
# worker threads on the card against a parameter server in host memory,
# over real TCP.  512 rows: 2 rounds a worker an epoch at 4 workers
HOST_PS = {**PS, "fidelity": "host"}
HOST_ROWS, HOST_EPOCHS = 512, 2
# (b) one worker, 64 rows: one round an epoch, 2 epochs
HOST_W1_ROWS = 64
# (c) int8 commits: 1 byte an element and a few bytes of msgpack a leaf
# against 4, so the wire/raw ratio sits just above 1/4
HOST_INT8_RATIO = (0.25, 0.26)
# (e) chaos on the wire: resets and truncations under the retry budget,
# a snapshot after every commit
HOST_CHAOS = dict(reset_rate=0.05, truncate_rate=0.05, skip_ops=8,
                  max_injections=4)
HOST_RETRIES = 8
# (f) the commit's round trip, median of a few; the profiled epoch at
# 256 rows (one round a worker)
HOST_RTT_REPS = 3
HOST_PROFILE_ROWS = 256


def _host_trainer(cfg, seed, torch, **kw):
    from distkeras_tpu_torch import ADAG

    return ADAG(cfg, seed=seed, learning_rate=PS_LR, lr_law="scale",
                device="cuda", **{**HOST_PS, "num_epoch": HOST_EPOCHS, **kw})


def _host_checks(trainer, name, np, workers):
    """Finite losses, the server's clock equal to the commits the
    workers made, every staleness >= 0; returns rounds and staleness."""
    hist = trainer.history
    losses = hist["round_loss"]
    (stale,) = hist["staleness"] if "staleness" in hist else ([],)
    ps = trainer.parameter_server_state
    print(f"host {name}: commits={len(losses)} clock={ps.num_commits} "
          f"epoch_loss={hist['epoch_loss']} round_loss="
          f"{np.round(losses, 4).tolist()} staleness={stale} "
          f"training_time_s={trainer.training_time:.3f}")
    if not np.isfinite(losses).all() or not np.isfinite(
            hist["epoch_loss"]).all():
        raise SystemExit(f"host {name}: losses not finite")
    if ps.num_commits != len(losses) or len(stale) != len(losses) \
            or min(stale) < 0:
        raise SystemExit(f"host {name}: the PS clock {ps.num_commits} is "
                         f"not the {len(losses)} commits made, or a "
                         f"staleness is negative: {stale}")
    if len(losses) % workers:
        raise SystemExit(f"host {name}: {len(losses)} commits from "
                         f"{workers} workers")
    return len(losses), stale


def _commit_rtt(center, torch, np):
    """One commit's round trip over loopback TCP with the 102 MB center:
    the client packs its tree, sends it, the server applies ADAG and
    packs the reply, the client unpacks it; and the parts alone."""
    from distkeras_tpu_torch.parallel import host_ps
    from distkeras_tpu_torch.parallel import update_rules as rules
    from distkeras_tpu_torch.parallel.trees import tree_map

    rng = np.random.default_rng(0)
    delta = tree_map(lambda x: (1e-4 * rng.standard_normal(x.shape))
                     .astype(np.float32), center)
    ps = host_ps.HostParameterServer(rules.AdagRule(), center)
    server = host_ps.PSServer(ps, center).start()
    client = host_ps.PSClient(*server.address, worker_id=0, template=center)
    try:
        rtt, pack, apply = [], [], []
        for i in range(HOST_RTT_REPS):
            t0 = time.perf_counter()
            client.commit(delta, seq=i)
            rtt.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            host_ps.pack_params(delta, center)
            pack.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            ps.commit(1, delta)
            apply.append(time.perf_counter() - t0)
        client.done()
    finally:
        client.close()
        server.stop()
    nbytes = len(host_ps.pack_params(center))
    res = {"center_bytes": nbytes,
           "commit_rtt_ms": float(np.median(rtt)) * 1e3,
           "pack_ms": float(np.median(pack)) * 1e3,
           "apply_and_reply_pack_ms": float(np.median(apply)) * 1e3,
           "reps": HOST_RTT_REPS}
    print(f"host rtt: one commit of the {nbytes}-byte center over loopback "
          f"TCP (pack, send, apply, reply, unpack) "
          f"{res['commit_rtt_ms']:.3f} ms median of {HOST_RTT_REPS}; "
          f"pack alone {res['pack_ms']:.3f} ms, the server's apply with "
          f"its reply's pack {res['apply_and_reply_pack_ms']:.3f} ms")
    return res


def _host_profile(cfg, data, seed, start, torch):
    """One epoch of the socket arm under ``torch.profiler``: the
    device's busy time against the run's own (profiled) wall."""
    from torch.profiler import ProfilerActivity, profile

    trainer = _host_trainer(cfg, seed, torch, transport="socket",
                            num_epoch=1)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trainer.train(data, initial_variables=start)
        torch.cuda.synchronize()
    wall = time.monotonic() - t0
    kernels = _device_kernels(prof, torch)
    busy = sum(kernels.values())
    res = {"wall_s": wall, "device_busy_ms": busy,
           "idle_share": 1 - busy / 1e3 / wall,
           "commits": len(trainer.history["round_loss"])}
    print(f"host profile: one epoch of the socket arm at 4 workers, "
          f"{res['commits']} "
          f"commits in {wall:.3f} s (profiled), device busy {busy:.3f} ms, "
          f"idle share {res['idle_share']:.4f}")
    return res


def _host_ps_phase(seed, torch, np, gn, emulated_round_ms):
    """Phase 10: ADAG on the host arm over ResNet-50 (#5-#6); see the
    module docstring.  Returns the numbers and the GroupNorm launch
    counts of run (a)."""
    import tempfile

    from distkeras_tpu_torch import telemetry
    from distkeras_tpu_torch.data import datasets
    from distkeras_tpu_torch.models import model_config
    from distkeras_tpu_torch.parallel import faults, host_ps
    from distkeras_tpu_torch.parallel import update_rules as rules

    t_phase = time.monotonic()
    cfg = model_config("resnet", (IMAGE, IMAGE, 3), **RESNET)
    data = datasets.imagenet_synth(HOST_ROWS, image_size=IMAGE,
                                   num_classes=RESNET["num_classes"],
                                   seed=seed)
    w, k = HOST_PS["num_workers"], HOST_PS["communication_window"]
    res: dict = {}

    # (a) 4 worker threads over TCP, 2 epochs
    trainer = _host_trainer(cfg, seed, torch, transport="socket")
    start = {n: v.clone() for n, v in trainer.model.state_dict().items()}
    per_step = sum(_resnet_shapes(trainer.model, PS["batch_size"],
                                  torch)[0].values())
    torch.cuda.synchronize()
    _reset_gn(gn)
    trainer.train(data, initial_variables=start)
    torch.cuda.synchronize()
    launches = _gn_counts(gn)
    routes = dict(gn.route_launches)
    commits, stale = _host_checks(trainer, "socket W=4", np, w)
    want = per_step * k * commits
    print(f"host socket W=4: GroupNorm launches {launches} by route "
          f"{routes}; {per_step} a step x {k} steps x {commits} windows")
    if any(n != want for n in launches.values()) or routes != {
            "fwd_one_pass": want, "fwd_two_pass": 0,
            "bwd_one_pass": want, "bwd_two_pass": 0}:
        raise SystemExit(f"host arm: GroupNorm launches {launches} "
                         f"({routes}) across {w} threads; expected {want} "
                         f"each, all one-pass")
    rounds_per_worker = commits // w
    res["socket"] = {"commits": commits, "staleness": stale,
                     "round_loss": trainer.history["round_loss"],
                     "epoch_loss": trainer.history["epoch_loss"],
                     "training_time_s": trainer.training_time,
                     "round_ms": trainer.training_time / rounds_per_worker
                     * 1e3, "group_norm_launches": launches,
                     "group_norm_routes": routes,
                     "emulated_round_ms": emulated_round_ms}
    print(f"host socket W=4: round_ms={res['socket']['round_ms']:.3f} "
          f"(the run's training_time over its {rounds_per_worker} rounds "
          f"a worker, 4 workers' windows and commits in flight together) "
          f"against the emulated round's {emulated_round_ms:.3f} ms "
          f"(phase 5)")
    del trainer
    torch.cuda.empty_cache()

    # (b) determinism at W=1: socket, inprocess and faithful from one start
    one = data.take(HOST_W1_ROWS)
    runs = {}
    for name, kw in (("socket", dict(transport="socket")),
                     ("inprocess", dict(transport="inprocess")),
                     ("faithful", dict(fidelity="faithful"))):
        t = _host_trainer(cfg, seed, torch, num_workers=1, **kw)
        out = t.train(one, initial_variables=start)
        runs[name] = ({n: v.detach().clone() for n, v in out.items()},
                      t.history["round_loss"])
        del t
    same = {name: all(torch.equal(runs["socket"][0][n], v[0][n])
                      for n in v[0]) and v[1] == runs["socket"][1]
            for name, v in runs.items()}
    print(f"host W=1: socket bit-equal to inprocess {same['inprocess']} "
          f"and to faithful {same['faithful']}; round_loss "
          f"{runs['socket'][1]}")
    if not (same["inprocess"] and same["faithful"]):
        raise SystemExit("host arm at W=1: socket, inprocess and faithful "
                         "runs from one start are not bit-equal")
    res["w1"] = {"round_loss": runs["socket"][1], "bit_equal": same}
    del runs
    torch.cuda.empty_cache()

    # (c) int8 commits over TCP, 2 workers, one epoch
    trainer = _host_trainer(cfg, seed, torch, transport="socket",
                            compression="int8", num_workers=2, num_epoch=1)
    trainer.train(data, initial_variables=start)
    _host_checks(trainer, "int8 W=2", np, 2)
    ratio = trainer.history["commit_wire_bytes"][0] \
        / trainer.history["commit_raw_bytes"][0]
    print(f"host int8: wire {trainer.history['commit_wire_bytes'][0]} "
          f"bytes of raw {trainer.history['commit_raw_bytes'][0]}, "
          f"ratio {ratio:.5f}")
    if not HOST_INT8_RATIO[0] < ratio < HOST_INT8_RATIO[1]:
        raise SystemExit(f"int8 wire/raw ratio {ratio} outside "
                         f"{HOST_INT8_RATIO}")
    res["int8"] = {"wire_bytes": trainer.history["commit_wire_bytes"][0],
                   "raw_bytes": trainer.history["commit_raw_bytes"][0],
                   "ratio": ratio,
                   "round_loss": trainer.history["round_loss"]}
    del trainer
    torch.cuda.empty_cache()

    # (d) two shards over TCP, 4 workers, one epoch
    trainer = _host_trainer(cfg, seed, torch, transport="socket",
                            ps_shards=2, num_epoch=1)
    trainer.train(data, initial_variables=start)
    commits, _ = _host_checks(trainer, "sharded K=2", np, w)
    hist = trainer.history
    print(f"host sharded: pull_shards_skipped={hist['pull_shards_skipped']}"
          f" pull_bytes_saved={hist['pull_bytes_saved']}")
    res["sharded"] = {"commits": commits,
                      "pull_shards_skipped": hist["pull_shards_skipped"][0],
                      "pull_bytes_saved": hist["pull_bytes_saved"][0],
                      "round_loss": hist["round_loss"]}
    del trainer
    torch.cuda.empty_cache()

    # (e) resets and truncations on the wire under the retry budget; a
    # snapshot after every commit, read back by a restarted server
    with tempfile.TemporaryDirectory() as tmp:
        snap = Path(tmp) / "ps.snap"
        tel = telemetry.enable()
        chaos = faults.ChaosTransport(seed=seed, **HOST_CHAOS)
        try:
            trainer = _host_trainer(
                cfg, seed, torch, transport="socket", num_workers=2,
                num_epoch=1, worker_retries=HOST_RETRIES,
                ps_snapshot_path=str(snap), ps_snapshot_every=1)
            with chaos:
                trainer.train(data, initial_variables=start)
        finally:
            telemetry.disable()
        commits, _ = _host_checks(trainer, "chaos W=2", np, 2)
        m = tel.metrics
        dedup = m.sum_counter("ps_commit_dedup_total")
        applied = m.sum_counter("ps_commits_total")
        retries = m.sum_counter("ps_client_retries_total")
        ps = trainer.parameter_server_state
        print(f"host chaos: injected {chaos.counts}, client retries "
              f"{retries}, commits applied {applied} of {commits} sent, "
              f"duplicates answered from the reply cache {dedup}, "
              f"snapshots {ps.num_snapshots}")
        if applied != commits or ps.num_commits != commits \
                or not sum(chaos.counts.values()):
            raise SystemExit(f"chaos run: {applied} commits applied for "
                             f"{commits} sent (faults {chaos.counts})")
        back = host_ps.PSServer.restart_from(
            str(snap), rules.AdagRule(), ps.center)
        try:
            same_snap = (host_ps.pack_params(back.ps.center)
                         == host_ps.pack_params(ps.center)
                         and back.ps.num_commits == ps.num_commits
                         and back.ps.staleness_log == ps.staleness_log)
        finally:
            back.stop()
        print(f"host chaos: the last snapshot restarted bit-equal "
              f"{same_snap}")
        if not same_snap:
            raise SystemExit("PS snapshot read back by restart_from is not "
                             "the server's state")
        res["chaos"] = {"faults": dict(chaos.counts), "retries": retries,
                        "commits": commits, "applied": applied,
                        "dedup": dedup, "snapshots": ps.num_snapshots,
                        "restart_bit_equal": same_snap}
        center = ps.center
        del trainer, ps
    torch.cuda.empty_cache()

    # (f) the commit round trip, and the device's idle share
    res["rtt"] = _commit_rtt(center, torch, np)
    res["profile"] = _host_profile(cfg, data.take(HOST_PROFILE_ROWS), seed,
                                   start, torch)
    res["phase_s"] = time.monotonic() - t_phase
    print(f"host: phase took {res['phase_s']:.1f} s")
    return res, launches


# ---- phase 11: out-of-core data and the baseline families -------------

# (a) phase 5's model and round (ResNet-50, norm="group_pallas", #5-#6,
# faithful ADAG at lr_law="scale", 4 workers, window 2, batch 32) over
# imagenet_synth rows written as npz shards: OOC_SHARDS of OOC_SHARD_ROWS
# (one round each) and a runt of OOC_RUNT, too small for a batch a worker
OOC_SHARD_ROWS, OOC_SHARDS, OOC_RUNT = 256, 4, 100
OOC_HOST_WORKERS = 2
# (b) BASELINE row 5, the Criteo Wide & Deep: criteo_synth at its
# published widths (13 dense, 26 categorical; raw categories drawn from
# 1000 a feature, criteo_synth's default) in CSV shards, the ETL's
# 10,000 hash buckets a feature, wide_deep at its module defaults
CRITEO = dict(num_dense=13, num_categorical=26, vocab_size=10000,
              embed_dim=16, deep=(256, 128, 64), num_classes=2)
CRITEO_RAW_VOCAB = 1000
CRITEO_SHARDS, CRITEO_ROWS = 8, 32768
CRITEO_TRAIN = dict(num_workers=4, communication_window=2, batch_size=512,
                    worker_optimizer="adam", learning_rate=1e-3,
                    num_epoch=2, loss="sparse_categorical_crossentropy")
CRITEO_ACC = 0.6          # tests/test_baseline_configs.py's bar
# (c) BASELINE row 4, the IMDB BiLSTM at its module defaults
IMDB = dict(vocab_size=20000, embed_dim=128, hidden_dim=128, num_classes=2)
IMDB_ROWS, IMDB_T = 16384, 256
IMDB_TRAIN = dict(num_workers=4, communication_window=2, batch_size=64,
                  worker_optimizer="adam", learning_rate=1e-3, num_epoch=2,
                  loss="sparse_categorical_crossentropy")
# the cuDNN recurrence against the plain time loop, f32 without TF32:
# logits and every gradient within TOL_LSTM of their rms (summation
# order over 256 steps of a 128-wide cell)
TOL_LSTM = 1e-4


def _ooc_runs(seed, torch, np, gn, tmp):
    """Phase 11 (a): npz shards through the PS trainer on #5-#6."""
    from distkeras_tpu_torch import ADAG
    from distkeras_tpu_torch.data import ShardedDataset, datasets
    from distkeras_tpu_torch.models import model_config

    cfg = model_config("resnet", (IMAGE, IMAGE, 3), **RESNET)
    w, k = PS["num_workers"], PS["communication_window"]
    t0 = time.monotonic()
    full = datasets.imagenet_synth(OOC_SHARDS * OOC_SHARD_ROWS + OOC_RUNT,
                                   image_size=IMAGE,
                                   num_classes=RESNET["num_classes"],
                                   seed=seed)
    paths = full.to_npz_shards(str(Path(tmp) / "img"), OOC_SHARD_ROWS)
    one = full.take(OOC_SHARD_ROWS)
    del full
    print(f"ooc: {len(paths)} npz shards ({OOC_SHARDS} x {OOC_SHARD_ROWS} "
          f"+ {OOC_RUNT} rows, {Path(paths[0]).stat().st_size / 1e6:.1f} MB "
          f"a full shard) written in {time.monotonic() - t0:.1f} s")
    res: dict = {"launches": {"group_norm_fwd": 0, "group_norm_bwd": 0},
                 "routes": {r: 0 for r in gn.route_launches}}

    def trainer(**kw):
        return ADAG(cfg, seed=seed, learning_rate=PS_LR, lr_law="scale",
                    device="cuda", **{**PS, **kw})

    first = trainer()
    per_step = sum(_resnet_shapes(first.model, PS["batch_size"],
                                  torch)[0].values())
    start = {n: v.clone() for n, v in first.model.state_dict().items()}
    del first

    def run(name, data, windows_of, **kw):
        t = trainer(**kw)
        torch.cuda.synchronize()
        _reset_gn(gn)
        out = t.train(data, initial_variables=start)
        torch.cuda.synchronize()
        launches, routes = _gn_counts(gn), dict(gn.route_launches)
        want = per_step * k * windows_of(t)
        hist = t.history
        print(f"ooc {name}: rounds={len(hist['round_loss'])} round_loss="
              f"{np.round(hist['round_loss'], 4).tolist()} "
              f"skipped_segment_rows={hist.get('skipped_segment_rows')} "
              f"segment_stall_s={hist.get('segment_stall_s')} GroupNorm "
              f"launches {launches} ({per_step} a step)")
        if any(n != want for n in launches.values()) or routes != {
                "fwd_one_pass": want, "fwd_two_pass": 0,
                "bwd_one_pass": want, "bwd_two_pass": 0}:
            raise SystemExit(f"ooc {name}: GroupNorm launches {launches} "
                             f"({routes}); expected {want} each, one-pass")
        if not np.isfinite(hist["round_loss"]).all():
            raise SystemExit(f"ooc {name}: losses not finite")
        for key in launches:
            res["launches"][key] += launches[key]
        for key in routes:
            res["routes"][key] += routes[key]
        return ({n: v.detach().clone() for n, v in out.items()},
                list(hist["round_loss"]), dict(hist), t)

    def same(a, b):
        return a[1] == b[1] and all(torch.equal(a[0][n], b[0][n])
                                    for n in a[0])

    def emulated(t):
        return w * len(t.history["round_loss"])

    # one shard against the same rows in memory, from one start
    mem = run(f"in-memory {OOC_SHARD_ROWS}", one, emulated, num_epoch=2)
    ooc = run(f"one shard {OOC_SHARD_ROWS}", ShardedDataset([paths[0]]),
              emulated, num_epoch=2)
    res["one_shard_bit_equal"] = same(mem, ooc)
    print(f"ooc: one shard bit-equal to the same rows in memory "
          f"{res['one_shard_bit_equal']}")
    if not res["one_shard_bit_equal"]:
        raise SystemExit("ooc: one npz shard is not bit-equal to the same "
                         "rows in memory")
    del mem, ooc

    # four shards and the runt, prefetch on against off
    import os

    runs = {}
    for depth in ("1", "0"):
        os.environ["DKT_SEGMENT_PREFETCH"] = depth
        try:
            runs[depth] = run(f"shards prefetch {depth}",
                              ShardedDataset(paths), emulated, num_epoch=1)
        finally:
            os.environ.pop("DKT_SEGMENT_PREFETCH", None)
        hist = runs[depth][2]
        if hist["skipped_segment_rows"] != [OOC_RUNT] \
                or len(hist["round_loss"]) != OOC_SHARDS:
            raise SystemExit(f"ooc: prefetch {depth}: skipped "
                             f"{hist.get('skipped_segment_rows')}, rounds "
                             f"{len(hist['round_loss'])}; expected "
                             f"[{OOC_RUNT}] and {OOC_SHARDS}")
    res["prefetch_bit_equal"] = same(runs["1"], runs["0"])
    res["segment_stall_s"] = {f"prefetch_{d}": runs[d][2]["segment_stall_s"]
                              for d in runs}
    res["epoch_time_s"] = {f"prefetch_{d}": runs[d][3].epoch_time_s
                           for d in runs}
    print(f"ooc: prefetch 1 bit-equal to 0 {res['prefetch_bit_equal']}; "
          f"segment_stall_s {res['segment_stall_s']}, epoch_time_s "
          f"{res['epoch_time_s']}")
    if not res["prefetch_bit_equal"]:
        raise SystemExit("ooc: prefetch on and off are not bit-equal")
    del runs
    torch.cuda.empty_cache()

    # the same shards through the host arm, 2 worker threads
    def host_windows(t):
        return len(t.history["round_loss"])

    host = run(f"host inprocess W={OOC_HOST_WORKERS}", ShardedDataset(paths),
               host_windows, num_epoch=1, fidelity="host",
               transport="inprocess", num_workers=OOC_HOST_WORKERS)
    ps = host[3].parameter_server_state
    commits = len(host[1])
    print(f"ooc host: server clock {ps.num_commits} for {commits} commits "
          f"made, training_time_s {host[3].training_time:.3f}")
    if ps.num_commits != commits or commits == 0:
        raise SystemExit(f"ooc host: clock {ps.num_commits} against "
                         f"{commits} commits")
    res["host"] = {"commits": commits, "clock": ps.num_commits,
                   "training_time_s": host[3].training_time}
    del host, ps
    torch.cuda.empty_cache()
    return res


def _criteo_shards(n_shards, rows, seed, np, datasets):
    """``criteo_synth(n_shards * rows, seed=seed)`` (one draw, so every
    shard shares its label rule) as the bytes of ``n_shards`` CSV files:
    its dense features, labels and category ids (its first two draws,
    redone to keep the ids as integers), dense as fixed ``0012.3456``,
    each category as ``cat_0123``, built as byte matrices (no per-field
    Python)."""
    n_d, n_c = CRITEO["num_dense"], CRITEO["num_categorical"]
    total = n_shards * rows
    ds = datasets.criteo_synth(total, num_dense=n_d, num_categorical=n_c,
                               vocab_size=CRITEO_RAW_VOCAB, seed=seed)
    rng = np.random.default_rng(seed)
    rng.lognormal(0.0, 1.0, size=(total, n_d))
    cats = rng.integers(0, CRITEO_RAW_VOCAB, size=(total, n_c))

    def digits(n, width):
        pows = 10 ** np.arange(width - 1, -1, -1, dtype=np.int64)
        return (n[..., None] // pows % 10 + 48).astype(np.uint8)

    def sep(shape, char):
        return np.full(shape + (1,), ord(char), np.uint8)

    header = ",".join([f"d{j}" for j in range(n_d)]
                      + [f"c{j}" for j in range(n_c)] + ["label"]) + "\n"
    prefix = np.frombuffer(b"cat_", np.uint8)
    out = []
    for s in range(n_shards):
        part = slice(s * rows, (s + 1) * rows)
        q = np.round(np.clip(ds["dense"][part].astype(np.float64), 0,
                             9999.9999) * 1e4).astype(np.int64)
        c = cats[part]
        body = np.concatenate([
            np.concatenate([digits(q // 10000, 4), sep(q.shape, "."),
                            digits(q % 10000, 4), sep(q.shape, ",")],
                           -1).reshape(rows, -1),
            np.concatenate([np.broadcast_to(prefix, c.shape + (4,)),
                            digits(c, 4), sep(c.shape, ",")],
                           -1).reshape(rows, -1),
            (ds["label"][part].astype(np.uint8) + 48)[:, None],
            np.full((rows, 1), ord("\n"), np.uint8)], -1)
        out.append(header.encode() + body.tobytes())
    return out


def _criteo_etl():
    from distkeras_tpu_torch.data import (AssembleTransformer,
                                          HashBucketTransformer,
                                          MinMaxTransformer, Pipeline)

    n_d, n_c = CRITEO["num_dense"], CRITEO["num_categorical"]
    return Pipeline(
        [AssembleTransformer([f"d{j}" for j in range(n_d)], "dense"),
         MinMaxTransformer("dense")]
        + [HashBucketTransformer(f"c{j}", CRITEO["vocab_size"])
           for j in range(n_c)]
        + [AssembleTransformer(["dense"] + [f"c{j}_bucket"
                                            for j in range(n_c)])])


def _criteo_run(seed, torch, np, tmp):
    """Phase 11 (b): BASELINE row 5 out of core."""
    from distkeras_tpu_torch import DOWNPOUR, native
    from distkeras_tpu_torch.data import Dataset, datasets
    from distkeras_tpu_torch.evaluators import AccuracyEvaluator
    from distkeras_tpu_torch.models import model_config
    from distkeras_tpu_torch.predictors import ModelPredictor

    if not native.available():
        raise SystemExit(f"native library: {native.why_unavailable()}")
    t0 = time.monotonic()
    paths = []
    for s, text in enumerate(_criteo_shards(CRITEO_SHARDS + 1, CRITEO_ROWS,
                                            seed, np, datasets)):
        p = Path(tmp) / f"criteo-{s:05d}.csv"
        p.write_bytes(text)
        paths.append(str(p))
    train_paths, holdout = paths[:-1], paths[-1]
    shard_mb = Path(paths[0]).stat().st_size / 1e6
    print(f"criteo: {CRITEO_SHARDS} + 1 CSV shards of {CRITEO_ROWS} rows "
          f"({shard_mb:.2f} MB each) written in {time.monotonic() - t0:.1f} s")

    # the two parse lanes on one shard, column for column, and their rates
    t0 = time.monotonic()
    c_lane = Dataset.from_csv(train_paths[0])
    c_s = time.monotonic() - t0
    available = native.available
    native.available = lambda: False
    try:
        t0 = time.monotonic()
        py_lane = Dataset.from_csv(train_paths[0])
        py_s = time.monotonic() - t0
    finally:
        native.available = available
    lanes_equal = c_lane.column_names == py_lane.column_names and all(
        c_lane[k].dtype == py_lane[k].dtype
        and np.array_equal(c_lane[k], py_lane[k])
        for k in c_lane.column_names)
    res = {"parse_mb_s": {"c": shard_mb / c_s, "python": shard_mb / py_s},
           "lanes_equal": lanes_equal, "shard_mb": shard_mb}
    print(f"criteo: C lane {res['parse_mb_s']['c']:.1f} MB/s, Python lane "
          f"{res['parse_mb_s']['python']:.1f} MB/s; lanes equal column for "
          f"column {lanes_equal}")
    if not lanes_equal:
        raise SystemExit("criteo: the C and Python CSV lanes disagree")

    base = Dataset.from_csv_shards(train_paths)
    etl = _criteo_etl()
    etl.fit(base.load_shard(0))
    sd = base.map(etl.transform)
    t0 = time.monotonic()
    sd.load_shard(1)
    res["etl_rows_s"] = CRITEO_ROWS / (time.monotonic() - t0)
    print(f"criteo: parse + ETL of one shard {res['etl_rows_s']:.0f} rows/s")

    cfg = model_config("wide_deep", (CRITEO["num_dense"]
                                     + CRITEO["num_categorical"],),
                       **CRITEO)
    t = DOWNPOUR(cfg, seed=seed, device="cuda", **CRITEO_TRAIN)
    native.reset_counts()
    t.train(sd)
    torch.cuda.synchronize()
    calls = dict(native.calls)
    loads = CRITEO_SHARDS * CRITEO_TRAIN["num_epoch"]
    hist = t.history
    rounds = len(hist["round_loss"]) // CRITEO_TRAIN["num_epoch"]
    res.update(native_calls=calls, epoch_loss=hist["epoch_loss"],
               segment_stall_s=hist["segment_stall_s"],
               epoch_time_s=t.epoch_time_s, rounds_per_epoch=rounds,
               round_ms=t.epoch_time_s[-1] / rounds * 1e3)
    print(f"criteo: DOWNPOUR {rounds} rounds an epoch, epoch_loss "
          f"{hist['epoch_loss']}, segment_stall_s {hist['segment_stall_s']}, "
          f"round_ms {res['round_ms']:.3f} (epoch 2's wall over its rounds), "
          f"C-lane calls {calls}")
    want = {"parse_csv": loads, "affine_scale": loads,
            "fnv1a_bucket": loads * CRITEO["num_categorical"],
            "dense_scatter": 0}
    if calls != want:
        raise SystemExit(f"criteo: C-lane calls {calls}; expected {want} "
                         f"(every shard parsed and bucketed in C)")
    losses = hist["epoch_loss"]
    if not np.isfinite(hist["round_loss"]).all() or not losses[1] < losses[0]:
        raise SystemExit(f"criteo: losses not finite or not falling {losses}")

    held = etl.transform(Dataset.from_csv(holdout))
    t0 = time.monotonic()
    scored = ModelPredictor(t.model, t.trained_variables, output="class",
                            batch_size=4096).predict(held)
    res["predict_rows_s"] = len(held) / (time.monotonic() - t0)
    res["holdout_accuracy"] = AccuracyEvaluator("prediction",
                                                "label").evaluate(scored)
    print(f"criteo: held-out accuracy {res['holdout_accuracy']:.4f} "
          f"(bar {CRITEO_ACC}), predicted {res['predict_rows_s']:.0f} rows/s")
    if not res["holdout_accuracy"] > CRITEO_ACC:
        raise SystemExit(f"criteo: held-out accuracy "
                         f"{res['holdout_accuracy']} not above {CRITEO_ACC}")
    del t
    torch.cuda.empty_cache()
    return res


def _imdb_run(seed, torch, np):
    """Phase 11 (c): BASELINE row 4."""
    from distkeras_tpu_torch import DynSGD, build_model
    from distkeras_tpu_torch.data import datasets
    from distkeras_tpu_torch.models import lstm, model_config

    cfg = model_config("bilstm", (IMDB_T,), input_dtype="int32", **IMDB)
    data = datasets.imdb_synth(IMDB_ROWS, seq_len=IMDB_T,
                               vocab_size=IMDB["vocab_size"], seed=seed)
    res: dict = {}

    # the cuDNN recurrence against the plain loop on one batch
    torch.manual_seed(seed)
    model = build_model(cfg)
    tok = np.array(data["features"][:IMDB_TRAIN["batch_size"]])
    tok[1, 10] = 0                       # a 0 inside the sequence
    tok = torch.from_numpy(tok).to("cuda")
    params = dict(model.named_parameters())
    cot = torch.randn(len(tok), IMDB["num_classes"], device="cuda",
                      generator=torch.Generator("cuda").manual_seed(seed))
    got = {}
    for route in ("fused", "loop"):
        model.recurrence = route
        torch.cuda.synchronize()
        t0 = time.monotonic()
        out = model(tok)
        grads = torch.autograd.grad((out * cot).sum(), list(params.values()))
        torch.cuda.synchronize()
        got[route] = ([out] + list(grads), time.monotonic() - t0)
    worst = max(((a - b).abs().max() / b.float().pow(2).mean().sqrt()
                 .clamp(min=1e-30)).item()
                for a, b in zip(got["fused"][0], got["loop"][0]))
    res["fused_vs_loop"] = worst
    res["step_ms"] = {r: got[r][1] * 1e3 for r in got}
    print(f"imdb: cuDNN recurrence against the plain loop, worst |diff| / "
          f"rms over logits and {len(params)} gradients {worst:.3e} (limit "
          f"{TOL_LSTM}); forward+backward {res['step_ms']['fused']:.2f} ms "
          f"fused, {res['step_ms']['loop']:.2f} ms loop (first calls)")
    if not worst <= TOL_LSTM:
        raise SystemExit(f"imdb: cuDNN recurrence off the loop by {worst}")
    del model, got

    for route in lstm.recurrence_calls:
        lstm.recurrence_calls[route] = 0
    t = DynSGD(cfg, seed=seed, device="cuda", **IMDB_TRAIN)
    t.train(data)
    torch.cuda.synchronize()
    hist = t.history
    w, k, b = (IMDB_TRAIN[x] for x in ("num_workers", "communication_window",
                                       "batch_size"))
    rounds = len(hist["round_loss"]) // IMDB_TRAIN["num_epoch"]
    tokens = rounds * w * k * b * IMDB_T
    res.update(epoch_loss=hist["epoch_loss"], rounds_per_epoch=rounds,
               round_ms=t.epoch_time_s[-1] / rounds * 1e3,
               tokens_per_s=tokens / t.epoch_time_s[-1],
               recurrence_calls=dict(lstm.recurrence_calls))
    print(f"imdb: DynSGD {rounds} rounds an epoch, epoch_loss "
          f"{hist['epoch_loss']}, round_ms {res['round_ms']:.3f}, "
          f"tokens/s {res['tokens_per_s']:.0f} (epoch 2), recurrence calls "
          f"{res['recurrence_calls']}")
    losses = hist["epoch_loss"]
    if not np.isfinite(hist["round_loss"]).all() or not losses[1] < losses[0]:
        raise SystemExit(f"imdb: losses not finite or not falling {losses}")
    steps = 2 * rounds * w * k * IMDB_TRAIN["num_epoch"]
    if res["recurrence_calls"] != {"fused": steps, "loop": 0}:
        raise SystemExit(f"imdb: recurrence calls {res['recurrence_calls']}"
                         f"; expected {steps} fused")
    del t
    torch.cuda.empty_cache()
    return res


def _data_phase(seed, torch, np, gn):
    """Phase 11: out-of-core data and the baseline families; see the
    module docstring.  Returns the numbers and run (a)'s GroupNorm
    launches and routes."""
    import tempfile

    t_phase = time.monotonic()
    res: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        res["ooc"] = _ooc_runs(seed, torch, np, gn, tmp)
        for p in Path(tmp).glob("img-*.npz"):
            p.unlink()
        res["criteo"] = _criteo_run(seed, torch, np, tmp)
    res["imdb"] = _imdb_run(seed, torch, np)
    res["phase_s"] = time.monotonic() - t_phase
    print(f"data: phase took {res['phase_s']:.1f} s")
    return res, res["ooc"]["launches"], res["ooc"]["routes"]


# ---- phase 12: the serving arms ---------------------------------------
#
# phase 3's model and weights (L12, d768, 12 heads, 4 KV heads, vocab
# 32768, max_len 2048, bf16, flash prefill), not cut, through every arm
# of DecodeEngine: the int8 KV cache, paged KV with its QoS, the prefix
# store and chunked prefill, speculative decoding, a weight swap and the
# KV-block handoff; f32 copies of the same weights where tokens must be
# equal across two spellings of one attention

# a prefix hit's first-token logits against the whole-prompt prefill's,
# in norm: |hit - whole| <= TOL_PREFIX_LOGITS * |whole|, the flash
# forward's bf16 limit taken relative: the hit reads its tail densely
# (its attention logits rounded to bf16), the whole prompt runs #1 (f32
# logits); the worst logit's |diff| / (|whole| + rms) is reported beside
# it (PERF.md §2)
TOL_PREFIX_LOGITS = 2e-2
# bf16 paths that read one attention through two spellings (#1 against
# the dense read, a T=1 step against a [1, k+1] verify) may part at a
# near-tie: at each first divergence the reference's top-2 logit margin
# must be at most this (PERF.md §2)
DIVERGE_MARGIN = 0.125
ARMS_SYSTEM = 1024      # the chat traffic's shared system prompt
ARMS_PAGE = 128


def _lm_model(tree, **over):
    """The LM of ``LM`` (with ``over``) on the card, weights from the flax
    ``tree`` through ``convert.params_from_flax``."""
    from distkeras_tpu_torch import build_model, convert
    from distkeras_tpu_torch.models import model_config

    cfg = {**LM, **over}
    model = build_model(model_config("transformer_lm", (cfg["max_len"],),
                                     input_dtype="int32", **cfg)).eval()
    model.load_state_dict(convert.params_from_flax(tree))
    return model


def _margin(model, prompt, want, j, torch, np):
    """The reference's top-2 logit margin for its token ``j``: prompt and
    its first ``j`` tokens prefilled, the next token's logits."""
    from distkeras_tpu_torch.models.generate import prefill

    ext = np.concatenate([prompt, want[:j]]).astype(np.int64)
    with torch.no_grad():
        cache = model.new_cache(1)
        logits = prefill(model, torch.as_tensor(
            ext, device=model.embed.weight.device)[None], cache)
    top = torch.topk(logits[0].float(), 2).values
    return float(top[0] - top[1])


def _agree(model, reqs, got, want, torch, np, what, exact=False):
    """Per-request token agreement of ``got`` against the reference
    ``want``; exact, or each first divergence's reference margin at most
    ``DIVERGE_MARGIN``.  Returns the counts and margins."""
    same, margins = 0, []
    for r in reqs:
        i = r["i"]
        g, w = np.asarray(got[i]), np.asarray(want[i])
        if len(g) != r["max_new_tokens"] or len(w) != len(g):
            raise SystemExit(f"{what}: request {i} gave {len(g)} tokens "
                             f"against {len(w)}")
        if np.array_equal(g, w):
            same += 1
            continue
        j = int(np.argmax(g != w))
        if exact:
            raise SystemExit(f"{what}: request {i} differs at token {j} "
                             f"of {len(g)}")
        m = _margin(model, r["prompt"], w, j, torch, np)
        margins.append({"i": i, "token": j, "margin": m})
        if m > DIVERGE_MARGIN:
            raise SystemExit(f"{what}: request {i} parts at token {j} "
                             f"where the reference's top-2 margin is "
                             f"{m:.4f} > {DIVERGE_MARGIN}")
    print(f"arms: {what}: {same}/{len(reqs)} requests token-equal"
          + (f", first divergences {margins}" if margins else ""))
    return {"equal": same, "of": len(reqs), "divergences": margins}


def _spans(tel, name):
    return [e for e in tel.tracer.events() if e["name"] == name]


def _serve_arms(seed, torch, np, attention, reqs, tokens, serve_tps):
    """Phase 12: the serving arms; see the module docstring.  ``reqs``,
    ``tokens`` and ``serve_tps`` are phase 3's requests, greedy tokens
    and tokens/s.  Returns the numbers, #1's launches on the phase's
    main paths and the check rows of #1 at the phase's new shapes."""
    import copy

    from distkeras_tpu_torch import DecodeEngine, generate, telemetry
    from distkeras_tpu_torch.models.generate import prefill
    from distkeras_tpu_torch.serving import pack_kv_blocks, unpack_kv_blocks

    t_phase = time.monotonic()
    res: dict = {"card": _card_line()}
    launches = 0
    new_shapes: set = set()
    hd, layers, vocab = LM["d_model"] // LM["num_heads"], LM["num_layers"], \
        LM["vocab_size"]
    tree = _flax_tree(np.random.default_rng(seed + 1), LM)  # phase 3's
    model = _lm_model(tree)
    kw = dict(slots=8, buckets=[512, 2048], prefill_align=128)
    warm = [{"prompt": reqs[0]["prompt"], "max_new_tokens": 2, "i": -1}]

    def served(engine, items, ordered=True):
        nonlocal launches
        _reset_counts(attention)
        t0 = time.monotonic()
        out = {r["i"]: r for r in engine.run(items, ordered=ordered)}
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        n = attention.launches
        launches += n
        for r in out.values():
            if "error" in r:
                raise SystemExit(f"arms: request {r['i']} failed: "
                                 f"{r['error']}")
        return out, wall, n

    def toks(out):
        return {i: r["tokens"] for i, r in out.items()}

    def tps(out, wall):
        return sum(len(r["tokens"]) for r in out.values()) / wall

    def need(n, want, what):
        if n != want:
            raise SystemExit(f"arms: {what}: flash kernel launched {n} "
                             f"times; expected {want}")

    # (a) int8 KV: phase 3's traffic
    m8 = _lm_model(tree, kv_cache_dtype="int8")
    e8 = DecodeEngine(m8, **kw)
    list(e8.run(warm))
    out8, wall8, n8 = served(e8, reqs)
    need(n8, layers * len(reqs), "int8 engine")
    want8 = {r["i"]: generate(m8, r["prompt"][None],
                              max_new_tokens=r["max_new_tokens"]
                              )[0, len(r["prompt"]):].cpu().numpy()
             for r in reqs}
    res["int8"] = {"agree_generate": _agree(m8, reqs, toks(out8), want8,
                                            torch, np, "int8 engine vs "
                                            "int8 generate()", exact=True)}
    e_bf = DecodeEngine(model, **kw)

    def pool_bytes(engine):
        return sum(t.numel() * t.element_size() for p in engine._pools
                   for t in p.cache.leaves())

    res["int8"].update({
        "kv_pool_bytes": pool_bytes(e8), "bf16_kv_pool_bytes":
        pool_bytes(e_bf), "kv_ratio": pool_bytes(e8) / pool_bytes(e_bf),
        "tokens_per_s": tps(out8, wall8), "bf16_tokens_per_s": serve_tps,
        "launches": n8})
    print(f"arms: int8: KV pools {res['int8']['kv_pool_bytes']} against "
          f"{res['int8']['bf16_kv_pool_bytes']} bytes "
          f"({res['int8']['kv_ratio']:.4f}), {res['int8']['tokens_per_s']:.1f}"
          f" tokens/s against phase 3's {serve_tps:.1f}")
    del e8, m8
    torch.cuda.empty_cache()

    # (b) paged: phase 3's traffic, step time against the envelope engine
    list(e_bf.run(warm))
    ep = DecodeEngine(model, kv_pages=256, page_size=ARMS_PAGE, **kw)
    list(ep.run(warm))
    step_ms = {}
    for name, engine in (("envelope", e_bf), ("paged", ep)):
        tel = telemetry.enable()
        try:
            out, wall, n = served(engine, reqs)
            step_ms[name] = [e["dur"] / 1e3 for e in _spans(tel, "decode_step")]
        finally:
            telemetry.disable()
        need(n, layers * len(reqs), f"{name} engine")
        _agree(model, reqs, toks(out), tokens, torch, np,
               f"{name} engine vs phase 3", exact=True)
        res[f"{name}_tokens_per_s"] = tps(out, wall)
    st = ep.paging_stats()
    if st["allocated_total"] != st["freed_total"] or ep.free_pages() != 256:
        raise SystemExit(f"arms: paged ledger unbalanced: {st}")
    res["paged"] = {"step_ms": float(np.mean(step_ms["paged"])),
                    "envelope_step_ms": float(np.mean(step_ms["envelope"])),
                    "steps": len(step_ms["paged"]),
                    "tokens_per_s": res.pop("paged_tokens_per_s"),
                    "envelope_tokens_per_s": res.pop(
                        "envelope_tokens_per_s")}
    print(f"arms: paged: step {res['paged']['step_ms']:.3f} ms against "
          f"the envelope's {res['paged']['envelope_step_ms']:.3f} ms over "
          f"{res['paged']['steps']} steps; tokens equal phase 3's")
    del ep

    # the preemption drills: one bucket of 4 slots, 4 priority-0 requests
    # fill a 20-page pool, then 2 priority-2 arrivals need pages
    rng = np.random.default_rng(seed + 12)
    drill = [{"prompt": rng.integers(0, vocab, (t,)), "max_new_tokens": n,
              "i": i, "priority": p}
             for i, (t, n, p) in enumerate(((600, 48, 0), (590, 48, 0),
                                            (610, 48, 0), (520, 48, 0),
                                            (200, 32, 2), (150, 32, 2)))]
    dkw = dict(slots=4, buckets=[2048], prefill_align=128)

    def run_drill(engine):
        nonlocal launches
        _reset_counts(attention)
        for r in drill[:4]:
            engine.submit(r["prompt"], max_new_tokens=r["max_new_tokens"],
                          priority=r["priority"], meta={"i": r["i"]})
        out = {r["i"]: r for r in engine.step()}
        for r in drill[4:]:
            engine.submit(r["prompt"], max_new_tokens=r["max_new_tokens"],
                          priority=r["priority"], meta={"i": r["i"]})
        out.update({r["i"]: r for r in engine.drain()})
        torch.cuda.synchronize()
        launches += attention.launches
        for r in out.values():
            if "error" in r:
                raise SystemExit(f"arms: drill request {r['i']} failed: "
                                 f"{r['error']}")
        return out, attention.launches

    ref, n_ref = run_drill(DecodeEngine(model, **dkw))
    need(n_ref, layers * len(drill), "drill, envelope")
    for mode in ("swap", "recompute"):
        tel = telemetry.enable()
        try:
            engine = DecodeEngine(model, kv_pages=20, page_size=ARMS_PAGE,
                                  preemption=mode, **dkw)
            out, n = run_drill(engine)
            m = tel.metrics
            pre = m.sum_counter("serving_preemptions_total")
            readmit = m.sum_counter("serving_readmissions_total")
            padded = [e["args"]["padded"] for e in _spans(tel, "prefill")]
        finally:
            telemetry.disable()
        st = engine.paging_stats()
        if pre < 1 or readmit < 1:
            raise SystemExit(f"arms: {mode} drill preempted {pre} and "
                             f"readmitted {readmit} requests")
        if (st["allocated_total"] != st["freed_total"]
                or engine.free_pages() != 20):
            raise SystemExit(f"arms: {mode} drill ledger unbalanced: {st}")
        if mode == "swap":
            need(n, layers * len(drill), "swap drill")
            agree = _agree(model, drill, toks(out), toks(ref), torch, np,
                           "swap drill vs the envelope engine", exact=True)
        else:
            # every re-prefill runs #1 on prompt + generated tokens
            need(n, layers * (len(drill) + int(readmit)), "recompute drill")
            new_shapes.update((1, LM["num_heads"], t, hd) for t in padded)
            agree = _agree(model, drill, toks(out), toks(ref), torch, np,
                           "recompute drill vs the envelope engine")
        res[f"{mode}_drill"] = {"preemptions": pre, "readmissions": readmit,
                                "launches": n, "agree": agree,
                                "prefill_padded": padded,
                                "pages": st["allocated_total"]}
    del engine
    torch.cuda.empty_cache()

    # (c) prefix store and chunked prefill: chat traffic sharing a system
    # prompt; TTFT with the store on and off
    system = rng.integers(0, vocab, (ARMS_SYSTEM,))
    chat = [{"prompt": np.concatenate([system, rng.integers(
                0, vocab, (int(t),))]), "max_new_tokens": 32, "i": i}
            for i, t in enumerate(rng.integers(64, 513, size=16))]
    e_off = DecodeEngine(model, **kw)
    list(e_off.run(warm))
    off, _, n_off = served(e_off, chat)
    need(n_off, layers * len(chat), "store off")
    tel = telemetry.enable()
    try:
        e_on = DecodeEngine(model, prefix_cache_bytes=1 << 30, **kw)
        warm_out = list(e_on.run(warm))
        on, _, n_first = served(e_on, chat[:1])
        rest, _, n_rest = served(e_on, chat[1:])
        on.update(rest)
        m = tel.metrics
        st = e_on.prefix_stats()
        n_tok = sum(len(r["tokens"]) for r in (*warm_out, *on.values()))
        tele = {"tokens_total": m.sum_counter("serving_tokens_total"),
                "tokens_returned": n_tok,
                "hits": m.sum_counter("serving_prefix_hits_total"),
                "misses": m.sum_counter("serving_prefix_misses_total"),
                "tokens_saved": m.sum_counter(
                    "serving_prefill_tokens_saved_total")}
    finally:
        telemetry.disable()
    # (f) the registry counts what the results and the store hold
    if (tele["tokens_total"] != n_tok or tele["hits"] != st["hits"]
            or tele["misses"] != st["misses"]
            or tele["tokens_saved"] != st["tokens_saved"]):
        raise SystemExit(f"arms: telemetry {tele} against the results and "
                         f"{st}")
    if st["hits"] != 15 or st["tokens_saved"] != 15 * ARMS_SYSTEM:
        raise SystemExit(f"arms: prefix store {st}: expected 15 hits of "
                         f"{ARMS_SYSTEM} tokens")
    need(n_first + n_rest, layers, "store on (one whole prefill)")
    ttft = {k: [float(v) for v in np.percentile(
        [r["ttft"] for i, r in out.items() if i > 0], [50, 95])]
        for k, out in (("on", on), ("off", off))}
    res["prefix"] = {
        "stats": st, "telemetry": tele, "launches": n_first + n_rest,
        "launches_store_off": n_off,
        "ttft_p50_s": ttft["on"][0], "ttft_p95_s": ttft["on"][1],
        "off_ttft_p50_s": ttft["off"][0], "off_ttft_p95_s": ttft["off"][1],
        "agree": _agree(model, chat, toks(on), toks(off), torch, np,
                        "prefix hits vs whole prefills")}
    print(f"arms: prefix: {st['hits']} hits, {st['tokens_saved']} tokens "
          f"saved; TTFT p50/p95 (requests 1-15) {ttft['on'][0]:.4f}/"
          f"{ttft['on'][1]:.4f} s on against {ttft['off'][0]:.4f}/"
          f"{ttft['off'][1]:.4f} s off")
    # a hit's first-token logits: chat[0]'s whole prefill supplies the
    # blocks, the tail reads them densely, as the engine runs it
    dense = copy.copy(model)
    dense.attn, dense.attn_fn = "dense", None
    dense.flash_attn = dense.blockwise_attn = False
    worst = worst_elem = 0.0
    dev = model.embed.weight.device
    with torch.no_grad():
        src = model.new_cache(1)
        prefill(model, torch.as_tensor(chat[0]["prompt"], device=dev)[None],
                src)
        for r in chat[1:4]:
            p = torch.as_tensor(r["prompt"], device=dev)[None]
            whole = prefill(model, p, model.new_cache(1))[0]
            hit = model.new_cache(1)
            for a, b in zip(hit.leaves(), src.leaves()):
                a[:, :, :ARMS_SYSTEM] = b[:, :, :ARMS_SYSTEM]
            t_p = p.shape[1]
            t_pad = -(-t_p // 128) * 128
            tail = torch.zeros(1, t_pad - ARMS_SYSTEM, dtype=torch.long,
                               device=dev)
            tail[0, :t_p - ARMS_SYSTEM] = p[0, ARMS_SYSTEM:]
            hit.index = ARMS_SYSTEM
            logits, _ = dense(tail, cache=hit,
                              last_index=t_p - 1 - ARMS_SYSTEM)
            diff = logits[0, -1].float() - whole
            rel = (diff.norm() / whole.norm()).item()
            elem = (diff.abs() / (whole.abs() + whole.pow(2).mean().sqrt())
                    ).max().item()
            worst = max(worst, rel)
            worst_elem = max(worst_elem, elem)
    res["prefix"]["logit_rel"] = worst
    res["prefix"]["logit_elem_ratio"] = worst_elem
    print(f"arms: prefix-hit first-token logits against whole prefills: "
          f"|diff| / |whole| {worst:.5f} (limit {TOL_PREFIX_LOGITS}); per "
          f"logit |diff| / (|whole| + rms) at most {worst_elem:.5f}")
    if worst > TOL_PREFIX_LOGITS:
        raise SystemExit("arms: prefix-hit logits off the whole prefill's")
    del e_off
    torch.cuda.empty_cache()

    # one long prompt in chunks of 256 beside three live decodes: the
    # neighbours gain tokens between its chunks
    ec = DecodeEngine(model, slots=4, buckets=[2048], prefill_align=128,
                      prefill_chunk=256)
    long = {"prompt": rng.integers(0, vocab, (2040,)), "max_new_tokens": 8,
            "i": 9}
    side = [{"prompt": rng.integers(0, vocab, (200,)), "max_new_tokens": 64,
             "i": i} for i in range(3)]
    _reset_counts(attention)
    for r in side:
        ec.submit(r["prompt"], max_new_tokens=64, meta={"i": r["i"]})
    out = {}
    for _ in range(len(side) + 1):  # one chunk a step: all decoding
        out.update({r["i"]: r for r in ec.step()})
    ec.submit(long["prompt"], max_new_tokens=8, meta={"i": 9})
    pool = ec._pools[0]
    gains, chunks = [], 0
    while ec.has_work():
        before = [len(q.tokens) for q in pool.reqs if q is not None
                  and q.meta["i"] < 9]
        mid = any(q is not None and q.meta["i"] == 9
                  for q in pool.reqs) and bool(pool.prefilling)
        out.update({r["i"]: r for r in ec.step()})
        if mid:
            chunks += 1
            after = [len(q.tokens) for q in pool.reqs if q is not None
                     and q.meta["i"] < 9]
            gains.append(sum(after) - sum(before)
                         if len(after) == len(before) else len(before))
    torch.cuda.synchronize()
    n_chunk = attention.launches
    launches += n_chunk
    # with chunking on every prefill is a dense chunk: no #1
    need(n_chunk, 0, "chunked prefill beside decodes")
    if chunks < 7 or min(gains) < 1:
        raise SystemExit(f"arms: neighbours gained {gains} tokens over "
                         f"{chunks} chunk steps")
    whole_long = generate(model, long["prompt"][None], max_new_tokens=8
                          )[0, 2040:].cpu().numpy()
    res["chunked"] = {"chunk_steps": chunks, "neighbour_gains": gains,
                      "agree": _agree(model, [long], {9: out[9]["tokens"]},
                                      {9: whole_long}, torch, np,
                                      "chunked 2040-token prompt vs "
                                      "generate()")}
    del ec

    # f32: the same weights, TF32 off; tokens equal across spellings
    m32 = _lm_model(tree, dtype="float32")
    chat32 = [{**r, "max_new_tokens": 8} for r in chat[:4]]
    base32, _, n32 = served(DecodeEngine(m32, **kw), chat32)
    e32 = DecodeEngine(m32, prefix_cache_bytes=1 << 30, **kw)
    on32, _, n_a = served(e32, chat32[:1])
    rest32, _, n_b = served(e32, chat32[1:])
    on32.update(rest32)
    need(n32 + n_a + n_b, layers * (len(chat32) + 1), "f32 store on/off")
    res["prefix"]["f32_agree"] = _agree(m32, chat32, toks(on32),
                                        toks(base32), torch, np,
                                        "f32 prefix hits vs whole prefills",
                                        exact=True)

    # (d) speculation: prompts that repeat a 64-token motif
    motif = rng.integers(0, vocab, (64,))
    spec_reqs = [{"prompt": np.tile(motif, 16)[:int(t)],
                  "max_new_tokens": 32, "i": i}
                 for i, t in enumerate(rng.integers(256, 1025, size=8))]
    dtree = _flax_tree(np.random.default_rng(seed + 13),
                       {**LM, "num_layers": 2})
    draft2 = _lm_model(dtree, num_layers=2)
    base, wall, n = served(DecodeEngine(model, **kw), spec_reqs)
    res["spec"] = {"base_tokens_per_s": tps(base, wall)}
    for name, spec in (("ngram", {"proposer": "ngram", "k": 4}),
                       ("self_draft", {"proposer": "draft", "k": 4,
                                       "draft_model": model}),
                       ("draft_2l", {"proposer": "draft", "k": 4,
                                     "draft_model": draft2})):
        tel = telemetry.enable()
        try:
            engine = DecodeEngine(model, speculative=spec, **kw)
            out, wall, n = served(engine, spec_reqs)
            dpad = [e["args"]["padded"]
                    for e in _spans(tel, "draft_prefill")]
        finally:
            telemetry.disable()
        n_draft = len(dpad) * spec.get("draft_model", model).num_layers \
            if name != "ngram" else 0
        need(n, layers * len(spec_reqs) + n_draft, f"spec {name}")
        new_shapes.update((1, LM["num_heads"], t, hd) for t in dpad
                          if t % 128 == 0)
        st = engine.spec_stats()
        res["spec"][name] = {
            "accept_rate": st["accept_rate"], "proposed": st["proposed"],
            "accepted": st["accepted"], "tokens_per_s": tps(out, wall),
            "launches": n, "draft_prefills": len(dpad),
            "agree": _agree(model, spec_reqs, toks(out), toks(base), torch,
                            np, f"spec {name} vs no speculation")}
        print(f"arms: spec {name}: accept rate {st['accept_rate']}, "
              f"{res['spec'][name]['tokens_per_s']:.1f} tokens/s against "
              f"{res['spec']['base_tokens_per_s']:.1f}")
    del engine
    spec32 = [{**r, "max_new_tokens": 16} for r in spec_reqs[:3]]
    base32, _, _ = served(DecodeEngine(m32, **kw), spec32)
    e32 = DecodeEngine(m32, speculative={"proposer": "draft", "k": 4,
                                         "draft_model": m32}, **kw)
    out32, _, _ = served(e32, spec32)
    st = e32.spec_stats()
    res["spec"]["f32_self_draft"] = {
        "accept_rate": st["accept_rate"], "proposed": st["proposed"],
        "agree": _agree(m32, spec32, toks(out32), toks(base32), torch, np,
                        "f32 self-draft vs no speculation", exact=True)}
    if st["accept_rate"] != 1.0:
        raise SystemExit(f"arms: f32 self-draft accept rate "
                         f"{st['accept_rate']}; expected 1.0")
    del e32, m32, base32, draft2
    torch.cuda.empty_cache()

    # (e) the handoff between two engines, then a swap mid-run
    e1 = DecodeEngine(model, prefix_cache_bytes=1 << 30, **kw)
    served(e1, chat[:1])
    export = e1.export_prefix(chat[1]["prompt"])
    wire = b"".join(bytes(p) for p in pack_kv_blocks(export))
    back = unpack_kv_blocks(wire)
    e2 = DecodeEngine(model, prefix_cache_bytes=1 << 30, **kw)
    installed = e2.import_prefix(back["prompt"], back["blocks"],
                                 weights_ver=back["weights_ver"])
    if installed != ARMS_SYSTEM // 128:
        raise SystemExit(f"arms: import installed {installed} blocks")
    got2, _, _ = served(e2, chat[1:2])
    got1, _, _ = served(e1, chat[1:2])
    hand = _agree(model, chat[1:2], toks(got2), toks(got1), torch, np,
                  "imported blocks vs the monolithic engine", exact=True)
    for r in chat[2:4]:
        e1.submit(r["prompt"], max_new_tokens=32, meta={"i": r["i"]})
    e1.step()
    keys = e1.compile_counts
    e1.swap_variables({k: v * 1.0078125 for k, v in e1.variables.items()})
    st = e1.prefix_stats()
    e1.drain()
    st_after = e1.prefix_stats()
    if (e1.compile_counts != keys or st["nodes"] != 0
            or st["invalidations"] != 1 or st_after["nodes"] != 0):
        raise SystemExit(f"arms: swap added keys or left the store: "
                         f"{st} {st_after}")
    res["handoff"] = {"wire_bytes": len(wire), "blocks": installed,
                      "agree": hand, "swap_store": st_after}
    print(f"arms: handoff: {installed} blocks in a {len(wire)}-byte frame, "
          f"tokens equal the monolithic engine's; the swap added no key "
          f"and emptied the store")
    del e1, e2, e_on, e_bf, model
    torch.cuda.empty_cache()

    # #1 at the phase's new shapes against its plain version
    checked = sorted(new_shapes)
    rows = _check_attention(attention, torch, checked) if checked else []
    res["checked_shapes"] = [list(s) for s in checked]
    res["launches"] = launches
    res["phase_s"] = time.monotonic() - t_phase
    print(f"arms: {launches} launches of #1 on the phase's paths; phase "
          f"took {res['phase_s']:.1f} s")
    return res, launches, rows


def _gn_summary(timing, mix, pre):
    """The ``kernels`` line's fields of a GroupNorm kernel: times
    launch-weighted over the path's (shape, ReLU) mix, the two-pass
    route's beside them, and each shape's route as launched."""
    total = sum(mix.values())

    def mean(field):
        return sum(n * timing[k][field] for k, n in mix.items()) / total

    out = {"ms": mean(f"{pre}_ms"), "plain_ms": mean(f"{pre}_plain_ms"),
           "bound_ms": mean(f"{pre}_bound_ms"),
           "library_ms": mean(f"{pre}_library_ms")}
    if all(f"{pre}_two_pass_ms" in timing[k] for k in mix):
        out["two_pass_ms"] = mean(f"{pre}_two_pass_ms")
    if all(f"{pre}_plan" in timing[k] for k in mix):
        out["by_shape"] = [
            {"key": list(k), "per_step": mix[k], "ms": v[f"{pre}_ms"],
             "bound_ms": v[f"{pre}_bound_ms"],
             **{f: v[f"{pre}_{f}"] for f in ("two_pass_ms", "other_k_ms")
                if f"{pre}_{f}" in v},
             **v[f"{pre}_plan"]}
            for k, v in sorted(timing.items())]
    return out


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
        print(f"chip_smoke: distkeras_tpu_torch is not in {root}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(root))
    from distkeras_tpu_torch import DecodeEngine, build_model, generate
    from distkeras_tpu_torch import convert
    from distkeras_tpu_torch.models import model_config
    from distkeras_tpu_torch.ops import _build, attention
    from distkeras_tpu_torch.ops import fused_block as fb
    from distkeras_tpu_torch.ops import group_norm as gn

    # full-f32 matmuls in the plain versions; no reduced-precision
    # split-K in bf16 products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    # ---- 1. build ---------------------------------------------------
    t0 = time.monotonic()
    libs = _build.build(["flash_attention_fwd", "flash_attention_bwd",
                         "group_norm", "fused_block", "flash_hop"])
    print(f"build: {time.monotonic() - t0:.1f} s")
    for name, so in libs.items():
        for line in so.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")
    ptxas = {row: _kernel_resources(libs[lib].with_suffix(".log").read_text(),
                                    kernel)
             for row, (lib, kernel) in PTXAS_ROWS.items()}
    for row, epis in PTXAS_EPILOGUES.items():
        ptxas[row] = {k: v for k, v in ptxas[row].items()
                      if k.split("_")[0] in epis}
    gn_log = libs["group_norm"].with_suffix(".log").read_text()
    ptxas.update({row: _gn_resources(gn_log, names)
                  for row, names in GN_KERNELS.items()})
    for row, res in ptxas.items():
        print(f"ptxas {row}: {res}")
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
    serve_mix: dict = {}  # one launch per layer per admission, padded
    for t in lengths:
        key = (1, LM["num_heads"], -(-int(t) // 128) * 128, hd)
        serve_mix[key] = serve_mix.get(key, 0) + LM["num_layers"]

    # the training path launches each kernel once per layer per step at
    # [8, 12, 1024, 64]
    train_steps = TRAIN_EPOCHS * (TRAIN_ROWS // TRAIN["batch_size"])
    fwd_mix = dict(serve_mix)
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
        [BWD_SHAPE, (1, 12, 128, 64), (8, 12, 512, 64), (2, 4, 200, 128)],
        extra=[(BWD_SHAPE_D128, "bfloat16", True)])
    bwd_timing, bwd_whole = _time_attention_bwd(attention, torch, F,
                                                BWD_SHAPE)
    bwd_timing_d128, _ = _time_attention_bwd(attention, torch, F,
                                             BWD_SHAPE_D128)
    torch.cuda.empty_cache()

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
    serve_tps = n_tok / wall
    serve_tokens = {r["i"]: r["tokens"] for r in results}
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

    # ---- 5. PS training path ------------------------------------------
    # the path's GroupNorm shapes and FLOPs, read off one forward
    probe = build_model(model_config("resnet", (IMAGE, IMAGE, 3),
                                     **RESNET), device="cuda")
    gn_mix, _ = _resnet_shapes(probe, PS["batch_size"], torch)
    del probe
    gn_shapes = sorted({key[:4] for key in gn_mix})
    print(f"group_norm: the PS path's shapes [B, HW, C, G, relu] x per "
          f"step: {sorted(gn_mix.items())}")
    gn_rows = _check_group_norm(gn, torch, gn_shapes + list(GN_EXTRA_SHAPES),
                                reruns=gn_shapes)
    gn_timing = _time_group_norm(gn, torch, F, gn_mix)
    torch.cuda.empty_cache()
    ps, ps_counts = _ps_train(args.seed, torch, np)
    torch.cuda.empty_cache()

    # ---- 6. fused ResNet path -----------------------------------------
    # the path's fused calls per step, read off one forward at batch 256
    probe = build_model(model_config("resnet", (IMAGE, IMAGE, 3), **FUSED),
                        device="cuda")
    conv_mix, tail_mix = _fused_shapes(fb, probe, FUSED_TRAIN["batch_size"],
                                       torch)
    del probe
    print(f"fused_block: the path's calls [B, HW, Cin, Cout, G, relu] x "
          f"per step: {sorted(conv_mix.items())}; tail [B, HW, Cm, Cout, "
          f"G2, G3]: {sorted(tail_mix.items())}")
    fb_rows = _check_fused(fb, torch, sorted(conv_mix), sorted(tail_mix))
    fb_plan_rows = _check_fwd_plans(fb, torch, sorted(conv_mix),
                                    sorted(tail_mix))
    fb_timing = _time_fused(fb, torch, F, conv_mix, tail_mix)
    torch.cuda.empty_cache()
    fused, fb_counts = _fused_train(args.seed, torch, np, fb, conv_mix,
                                    tail_mix,
                                    ps["fwd_gflop_per_image"] * 1e9)
    torch.cuda.empty_cache()

    # ---- 7. sequence-parallel LM training path -------------------------
    hop_rows = _check_hops(attention, torch)
    hop_timing = _time_hops(attention, torch)
    torch.cuda.empty_cache()
    seq, hop_counts = _seq_train(args.seed, torch, np)
    torch.cuda.empty_cache()

    # ---- 8. the rest of the Trainer family -----------------------------
    family, family_counts, family_routes = _trainer_family(
        args.seed, torch, np, fb, gn)

    # ---- 9. checkpoints, kill-and-resume, evaluation, prediction -------
    ckpt, ckpt_counts = _checkpoint_phase(args.seed, torch, np, fb, gn)
    torch.cuda.empty_cache()

    # ---- 10. the host-wire parameter server --------------------------
    host, host_counts = _host_ps_phase(args.seed, torch, np, gn,
                                       ps["round_ms"])
    torch.cuda.empty_cache()

    # ---- 11. out-of-core data and the baseline families -------------
    data, data_counts, data_routes = _data_phase(args.seed, torch, np, gn)
    torch.cuda.empty_cache()

    # ---- 12. the serving arms -----------------------------------------
    arms, arms_launches, arms_rows = _serve_arms(
        args.seed, torch, np, attention, reqs, serve_tokens, serve_tps)
    torch.cuda.empty_cache()
    rows += arms_rows
    max_err = max(r["max_abs_err"] for r in rows if r["dtype"] == "bfloat16")

    # ---- 13. kernel table --------------------------------------------
    # the forward kernel's numbers are launch-weighted over both paths'
    # shapes (phase 4 checked the training path's counts), and over each
    # path's own: the serving prefills and the training shape; the
    # backward kernels run on the training path only
    total = sum(fwd_mix.values())
    fwd_paths = {"serve": serve_mix, "train": {BWD_SHAPE: fwd_mix[BWD_SHAPE]}}

    def mean(field, shapes=fwd_mix):
        return (sum(n * timing[s][field] for s, n in shapes.items())
                / sum(shapes.values()))

    def path_tflops(shapes):
        flops = sum(n * _attn_flops(*s, True) for s, n in shapes.items())
        return _tflops(flops, sum(n * timing[s]["ms"]
                                  for s, n in shapes.items()))

    by_ops = sum(n for s, n in fwd_mix.items()
                 if timing[s]["bound_by"] == "operations")
    by_path = {k: {"serve": serve_counts[k], "train": train_counts[k]}
               for k in train_counts}
    by_path["flash_attention_fwd"]["serve_arms"] = arms_launches
    kernels = [{"name": "flash_attention_fwd", "route": "cuda",
                "source": "distkeras_tpu_torch/csrc/flash_attention_fwd.cu",
                "replaces": "distkeras_tpu/ops/attention.py:76",
                "launches": (launches + train_counts["flash_attention_fwd"]
                             + arms_launches),
                "launches_by_path": by_path["flash_attention_fwd"],
                "max_abs_err": max_err, "max_err": max_err,
                "ms": mean("ms"), "plain_ms": mean("plain_ms"),
                "bound_ms": mean("bound_ms"),
                "bound_by": "operations" if 2 * by_ops >= total else "bytes",
                "library_ms": mean("library_ms"),
                "tflops": path_tflops(fwd_mix),
                "by_path": {path: {**{f: mean(f, shapes) for f in
                                      ("ms", "plain_ms", "bound_ms",
                                       "library_ms")},
                                   "tflops": path_tflops(shapes)}
                            for path, shapes in fwd_paths.items()},
                "ptxas": ptxas["flash_attention_fwd"]}]
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
            **bwd_timing[name], "d128": bwd_timing_d128[name],
            "ptxas": ptxas[name]})
    # the GroupNorm kernels' numbers are launch-weighted over the PS
    # path's (shape, ReLU) mix
    gn_paths = {"ps_train": ps_counts,
                "averaging_train": family_counts["averaging_train"],
                "ensemble_train": family_counts["ensemble_train"],
                "ckpt_ps": ckpt_counts["ckpt_ps"],
                "host_ps": host_counts, "ooc_ps": data_counts}
    gn_routes = {"ps_train": ps["group_norm_routes"], **family_routes,
                 "host_ps": host["socket"]["group_norm_routes"],
                 "ooc_ps": data_routes}
    for name, pre, out, line in (("group_norm_fwd", "fwd", "y", 56),
                                 ("group_norm_bwd", "bwd", "dx", 83)):
        kernels.append({
            "name": name, "route": "cuda",
            "source": "distkeras_tpu_torch/csrc/group_norm.cu",
            "replaces": f"distkeras_tpu/ops/pallas_kernels.py:{line}",
            "launches": sum(c[name] for c in gn_paths.values()),
            "launches_by_path": {p: c[name] for p, c in gn_paths.items()},
            "launches_by_route": {r: sum(v[f"{pre}_{r}"]
                                         for v in gn_routes.values())
                                  for r in ("one_pass", "two_pass")},
            "max_abs_err": max(r[f"{out}_err"] for r in gn_rows
                               if r["dtype"] == "bfloat16"),
            **_gn_summary(gn_timing, gn_mix, pre),
            "bound_by": "bytes",
            "reruns_bit_equal": sum(r.get("rerun_bit_equal", False)
                                    for r in gn_rows),
            "ptxas": ptxas[name]})
    # the fused kernels' numbers are launch-weighted over the path's
    # call shapes; "library" is null: no one PyTorch call computes these
    # functions, and the torch spelling of the region (n calls) stands
    # beside it
    for name, kind, pre, line, outs in (
            ("conv1x1_gn_fwd", "conv", "fwd", 94, ("y",)),
            ("conv1x1_gn_bwd", "conv", "bwd", 105, ("dx",)),
            ("bottleneck_tail_fwd", "tail", "fwd", 235, ("out",)),
            ("bottleneck_tail_bwd", "tail", "bwd", 249, ("dy2", "dres"))):
        mix = conv_mix if kind == "conv" else tail_mix
        n_all = sum(mix.values())

        def fb_mean(field, kind=kind, mix=mix, n_all=n_all):
            return sum(n * fb_timing[(kind, k)][field]
                       for k, n in mix.items()) / n_all

        by_ops = sum(n for k, n in mix.items()
                     if fb_timing[(kind, k)][f"{pre}_bound_by"]
                     == "operations")
        fb_paths = {"fused_train": fb_counts,
                    "sync_train": family_counts["sync_train"],
                    "ckpt_single": ckpt_counts["ckpt_single"],
                    "predict": ckpt_counts["predict"]}
        kernels.append({
            "name": name, "route": "cuda",
            "source": "distkeras_tpu_torch/csrc/fused_block.cu",
            "replaces": f"distkeras_tpu/ops/fused_block.py:{line}",
            "launches": sum(c[name] for c in fb_paths.values()),
            "launches_by_path": {p: c[name] for p, c in fb_paths.items()},
            "max_abs_err": max(r[f"{o}_err"] for r in fb_rows for o in outs
                               if r["dtype"] == "bfloat16"
                               and r["kernel"] == name.rsplit("_", 1)[0]),
            "ms": fb_mean(f"{pre}_ms"), "plain_ms": fb_mean(f"{pre}_plain_ms"),
            "bound_ms": fb_mean(f"{pre}_bound_ms"),
            "bound_by": "operations" if 2 * by_ops >= n_all else "bytes",
            "library_ms": None,
            "torch_spelling_ms": fb_mean(f"{pre}_spelled_ms"),
            "torch_spelling_calls": SPELLED_CALLS[kind],
            **({"ptxas": ptxas[name]} if name in ptxas else {}),
            "launched": _launched(fb_timing, kind, mix, pre),
            **({"plans": _plan_means(fb_timing, mix, kind, pre)}
               if name != "bottleneck_tail_bwd" else {})})
    # the hop kernels' numbers are launch-weighted over the ring's hop
    # mix (per layer and direction: 4 diagonal, 6 past, 6 dead hops); a
    # dead hop has no library call, so library_ms is weighted over the
    # live (diagonal and past) hops only, and live_ms is the kernel's
    # time over the same hops, to compare with it
    n_mix = sum(HOP_MIX.values())
    live = {hop: n for hop, n in HOP_MIX.items() if hop != "dead"}
    for name, line, outs in (("flash_hop_fwd", 408, ("acc",)),
                             ("flash_hop_bwd_dq", 454, ("dq",)),
                             ("flash_hop_bwd_dkv", 494, ("dk", "dv"))):

        def hop_mean(field, name=name, mix=HOP_MIX):
            return sum(n * hop_timing[(name, hop)][field]
                       for hop, n in mix.items()) / sum(mix.values())

        by_ops = sum(n for hop, n in HOP_MIX.items()
                     if hop_timing[(name, hop)]["bound_by"] == "operations")
        kernels.append({
            "name": name, "route": "cuda",
            "source": "distkeras_tpu_torch/csrc/flash_hop.cu",
            "replaces": f"distkeras_tpu/ops/attention.py:{line}",
            "launches": hop_counts[name],
            "launches_by_path": {"seq_train": hop_counts[name]},
            "max_abs_err": max(r[f"{o}_err"] for r in hop_rows for o in outs
                               if r["dtype"] == "bfloat16"),
            "ms": hop_mean("ms"), "plain_ms": hop_mean("plain_ms"),
            "bound_ms": hop_mean("bound_ms"),
            "bound_by": "operations" if 2 * by_ops >= n_mix else "bytes",
            "library_ms": hop_mean("library_ms", mix=live),
            "live_ms": hop_mean("ms", mix=live),
            "live_tflops": _tflops(
                sum(n * _hop_flops(name, HOP_SHAPE, hop)
                    for hop, n in live.items()) / sum(live.values()),
                hop_mean("ms", mix=live)),
            "library_over": "diagonal and past hops",
            **({"ptxas": ptxas[name]} if name in ptxas else {}),
            "by_hop": {hop: hop_timing[(name, hop)] for hop in HOP_MIX}})
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({
            "card": card, "checks": rows, "bwd_checks": bwd_rows,
            "timing": [{"shape": list(s), "launches_per_run": fwd_mix[s],
                        **timing[s]} for s in sorted(fwd_mix)],
            "bwd_timing": {**bwd_timing, "whole_backward": bwd_whole,
                           "shape": list(BWD_SHAPE)},
            "bwd_timing_d128": {**bwd_timing_d128,
                                "shape": list(BWD_SHAPE_D128)},
            "serve": {"requests": len(results), "tokens": n_tok,
                      "wall_s": wall, "tokens_per_s": n_tok / wall,
                      "ttft_p50_s": ttft[0], "ttft_p95_s": ttft[1]},
            "profile": prof, "train": train,
            "group_norm_checks": gn_rows,
            "group_norm_timing": [{"key": list(k), "per_step": gn_mix[k],
                                   **v} for k, v in gn_timing.items()],
            "ps_train": ps, "fused_block_checks": fb_rows,
            "fused_forward_plans": fb_plan_rows,
            "fused_block_timing": [{"kind": k[0], "key": list(k[1]), **v}
                                   for k, v in fb_timing.items()],
            "fused_train": fused, "hop_checks": hop_rows,
            "hop_timing": [{"kernel": k[0], "hop": k[1], **v}
                           for k, v in hop_timing.items()],
            "seq_train": seq, "trainer_family": family,
            "checkpoint": ckpt, "host_ps": host, "data": data,
            "serve_arms": arms, "kernels": kernels},
            indent=1))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0

if __name__ == "__main__":
    sys.exit(main())
