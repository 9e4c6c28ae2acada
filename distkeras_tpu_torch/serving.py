"""Continuous-batching decode engine: slot-based LM serving over a
persistent KV cache, the port of ``distkeras_tpu/serving.py``
``DecodeEngine`` with every arm of it.

* One KV pool per ``max_len`` bucket (cache envelope), each
  ``[slots, KVH, envelope, D]`` per layer, lives on the card across
  requests; a request goes to the smallest envelope that fits.
* A prefill right-pads the prompt to ``prefill_align``, replaces the
  slot's whole envelope and seeds generation from the true last token's
  logits.  The pool is written in place through views of the slot's
  rows.
* A step advances every slot of a bucket by ``steps_per_sync`` tokens
  (per-row ``slot_pos`` positions, per-slot eos / remaining-token
  state); finished rows are evicted and replaced between steps.

Greedy tokens equal ``models.generate`` per request.  ``queue_bound``
sheds at the door (``ShedError``), ``deadline`` expires queued, parked
and live requests into ``error`` results, a request whose prefill
raises comes back alone as an ``error`` result, ``drain()`` finishes
the backlog and ``close()`` cancels the rest (``error="engine_closed"``).

The arms, each as the JAX engine has it:

* ``prefix_cache_bytes``: a shared-prefix KV store, a trie over token
  ids at ``prefill_align`` granularity whose nodes hold ref-counted
  ``[1, KVH, align, D]`` segments per cache leaf (in the flax cache
  tree's flatten order); a hit is copied into the slot and only the
  tail prefilled, finished requests donate their aligned prompt blocks,
  LRU eviction keeps the byte budget.
* ``prefill_chunk``: prompts prefill as chunk programs through a dense
  read of the slot's cache at an offset, at most one chunk per pool per
  ``step()``, deadlines re-checked between chunks.
* ``kv_pages``: every bucket draws KV from one shared page pool
  (``paging``); each program gathers the slots' pages into the envelope
  layout, runs the envelope body unchanged and scatters back.  The QoS
  scheduler admits by priority (2 > 1 > 0, FIFO within a class),
  enforces per-tenant page quotas, and on exhaustion preempts the
  lowest-priority live request (``"swap"``: its pages to host memory,
  restored page-exact; ``"recompute"``: re-prefilled from prompt and
  generated tokens; ``"none"``: the grower is shed).
* ``speculative``: n-gram or draft-model proposals verified by one
  dense ``[1, k + 1]`` read (``speculative``); the output equals plain
  greedy decode.
* ``swap_variables`` installs new weights at the next step boundary:
  the model runs through ``torch.func.functional_call`` on a weights
  dict snapshotted once per ``step()``; a swap clears the prefix store
  and every slot's draft cache.
* ``export_prefix``/``import_prefix``/``match_blocks`` and
  ``pack_kv_blocks``/``unpack_kv_blocks``: the KV-block handoff, on the
  JAX engine's wire (frames cross between the packages both ways).

Nothing is compiled: ``compile_counts`` counts each distinct program
key the JAX engine traces (``("step", env)``, ``("prefill", env,
padded)``, ...) the first time the engine runs it, so the bounded
program-set contract reads the same on both.  Telemetry (a no-op until
``telemetry.enable()``) records the JAX engine's gauges, histograms,
counters, spans, instants and flight-recorder events.
"""

from __future__ import annotations

import collections
import copy
import struct
import threading
from typing import Iterable, Iterator, Mapping, Optional

import numpy as np
import torch
from torch.func import functional_call

from distkeras_tpu_torch import flight_recorder, paging, telemetry
from distkeras_tpu_torch import speculative as _speculative
from distkeras_tpu_torch.models.generate import (_ceil_to, _decode_model,
                                                 _select, decode_step,
                                                 prefill)
from distkeras_tpu_torch.models.transformer import KVCache
from distkeras_tpu_torch.parallel import transport

_UNSET = object()


class ShedError(RuntimeError):
    """``submit`` refused a request at the door: the admission queue is
    at ``queue_bound``.  ``reason`` is ``"queue_full"``; every shed also
    counts ``serving_shed_total{reason,bucket}``.  The request never
    entered the engine."""

    def __init__(self, reason: str, detail: str):
        super().__init__(detail)
        self.reason = reason


# ---------------------------------------------------------------------
# KV page-block wire codec (wire scope "kv")
# ---------------------------------------------------------------------
#
# One exported block set travels as ONE transport frame:
#   b"K" + meta_len(8B BE) + pack_obj(meta) + block0 leaves + block1 ...
# where meta carries the prompt, the block count, the exporter's weights
# version and one shape/dtype template per cache leaf; the leaf bytes
# carry no framing of their own (the receiver slices by the templates).

_KV_META_HDR = struct.Struct(">Q")
_TORCH_DTYPES = {name: dt for dt, name in paging.DTYPE_NAMES.items()}


def _leaf_view(s):
    """The raw bytes of one segment leaf (a host tensor or a numpy
    array, ``ml_dtypes``' bfloat16 included) as a uint8 buffer."""
    if isinstance(s, torch.Tensor):
        t = s.detach().to("cpu").contiguous().reshape(-1)
        return t.view(torch.uint8).numpy().data
    return np.ascontiguousarray(np.asarray(s)).view(np.uint8).data


def _leaf_from_bytes(buf, name: str, shape) -> torch.Tensor:
    """A host tensor of dtype ``name`` (numpy's spelling) from ``buf``;
    bfloat16 goes through its ``uint16`` view."""
    if name not in _TORCH_DTYPES:
        raise ValueError(f"kv frame names an unknown dtype {name!r}")
    if name == "bfloat16":
        arr = np.frombuffer(buf, np.uint16).copy()
        return torch.from_numpy(arr).view(torch.bfloat16).reshape(shape)
    return torch.from_numpy(np.frombuffer(buf, np.dtype(name)).copy()
                            ).reshape(shape)


def _itemsize(name: str) -> int:
    if name not in _TORCH_DTYPES:
        raise ValueError(f"kv frame names an unknown dtype {name!r}")
    return torch.empty((), dtype=_TORCH_DTYPES[name]).element_size()


def pack_kv_blocks(export: Mapping) -> list:
    """Wire parts for one ``export_prefix`` result (this engine's or the
    JAX engine's), ready for ``transport.send_msg_gather`` (or
    ``b"".join``).  The bytes equal the JAX package's packer's for the
    same host arrays."""
    blocks = export.get("blocks") or []
    meta = {"prompt": np.ascontiguousarray(export["prompt"],
                                           dtype=np.int32),
            "n_blocks": int(len(blocks)),
            "weights_ver": int(export.get("weights_ver", 0)),
            "leaves": (paging.leaf_templates(blocks[0])
                       if blocks else [])}
    mb = transport.pack_obj(meta)
    parts: list = [b"K", _KV_META_HDR.pack(len(mb)), mb]
    for segs in blocks:
        for s in segs:
            parts.append(_leaf_view(s))
    return parts


def unpack_kv_blocks(body) -> dict:
    """Inverse of ``pack_kv_blocks`` over a received frame body (bytes
    or a memoryview): the export dict with host-tensor blocks.  A
    malformed frame raises ``ValueError``: a desynced stream must not
    install garbage KV."""
    body = memoryview(body)
    if body.nbytes < 1 + _KV_META_HDR.size or bytes(body[:1]) != b"K":
        raise ValueError("not a kv page_blocks frame")
    (mlen,) = _KV_META_HDR.unpack(bytes(body[1:1 + _KV_META_HDR.size]))
    off = 1 + _KV_META_HDR.size
    if off + mlen > body.nbytes:
        raise ValueError("kv frame meta overruns the body")
    try:
        meta = transport.unpack_obj(body[off:off + mlen])
        n_blocks = int(meta["n_blocks"])
        tmpls = [(str(t["dtype"]), tuple(int(d) for d in t["shape"]))
                 for t in meta["leaves"]]
        prompt = np.asarray(meta["prompt"], np.int32)
        weights_ver = int(meta["weights_ver"])
    except Exception as e:
        raise ValueError(f"kv frame meta is malformed: {e!r}") from e
    off += mlen
    blocks = []
    for _ in range(n_blocks):
        segs = []
        for name, shape in tmpls:
            nb = _itemsize(name) * int(np.prod(shape, dtype=np.int64))
            if off + nb > body.nbytes:
                raise ValueError("kv frame leaf overruns the body")
            segs.append(_leaf_from_bytes(body[off:off + nb], name, shape))
            off += nb
        blocks.append(segs)
    if off != body.nbytes:
        raise ValueError(
            f"kv frame length mismatch: parsed {off} of {body.nbytes} "
            "bytes")
    return {"prompt": prompt, "n_blocks": n_blocks,
            "weights_ver": weights_ver, "blocks": blocks}


def _as_tensor(s, device) -> torch.Tensor:
    """A shipped segment leaf (host tensor, or numpy array with
    ``ml_dtypes``' bfloat16 allowed) on ``device``."""
    if isinstance(s, torch.Tensor):
        return s.to(device)
    arr = np.asarray(s)
    if str(arr.dtype) == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16)
                             .copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    return t.to(device)


# ---------------------------------------------------------------------
# host-side state
# ---------------------------------------------------------------------


class _Request:
    __slots__ = ("rid", "prompt", "max_new", "eos_id", "tokens", "meta",
                 "submit_order", "t_submit", "t_first", "t_last_tok",
                 "traces_seen", "deadline", "prefix_path", "weights_ver",
                 "tenant", "priority", "pages", "swap", "spec_on")

    def __init__(self, rid, prompt, max_new, eos_id, meta, submit_order,
                 deadline=None, tenant=None, priority=1):
        self.rid = rid
        self.prompt = prompt
        self.max_new = max_new
        self.eos_id = eos_id
        self.tokens: list[int] = []
        self.meta = meta
        self.submit_order = submit_order
        self.t_submit = telemetry.now()
        self.t_first = None
        self.t_last_tok = None         # inter-token gap anchor
        self.traces_seen = -1          # program keys seen at the anchor
        # absolute telemetry.now() expiry (None: no deadline)
        self.deadline = (None if deadline is None
                         else self.t_submit + deadline)
        self.prefix_path: tuple = ()   # pinned store nodes
        self.weights_ver = -1          # engine weights at prefill time
        self.tenant = tenant           # QoS: quota accounting key
        self.priority = priority       # QoS: 0 (lowest) .. 2 (highest)
        self.pages: list[int] = []     # paged mode: held page ids
        self.swap = None               # parked: host KV / restore plan
        self.spec_on = None            # per-request speculation override

    def ledger(self, env: Optional[int] = None) -> np.ndarray:
        """Prompt plus every generated token, the last ``env`` of them
        when an envelope is given: what a recompute readmission
        re-prefills and the n-gram proposer reads."""
        ext = np.concatenate([self.prompt,
                              np.asarray(self.tokens, np.int32)])
        return ext if env is None else ext[-env:]


class _PrefixNode:
    """One ``prefill_align`` block of a cached prefix: its K/V rows as
    ``[1, KVH, align, D|1]`` segments, one per 4-D cache leaf in the
    flax flatten order (envelope-free: one store serves every
    bucket)."""

    __slots__ = ("key", "parent", "children", "segments", "nbytes",
                 "refs", "last_use")

    def __init__(self, key, parent, segments):
        self.key = key
        self.parent = parent
        self.children: dict = {}
        self.segments = segments
        self.nbytes = sum(s.numel() * s.element_size() for s in segments)
        self.refs = 0
        self.last_use = 0


class _PrefixStore:
    """Longest-prefix index over aligned token-id blocks: a trie whose
    node at depth ``d`` holds block ``d``'s segments.  ``match`` walks a
    prompt to its longest cached path, donation inserts a finished
    request's blocks, ``evict_to_budget`` drops least recently used
    childless unreferenced nodes until the bytes fit.  Mutated on the
    stepping thread only, but ``clear``, which the engine serializes
    under its admission lock."""

    def __init__(self, align: int, budget: int):
        self.align = align
        self.budget = budget
        self.root = _PrefixNode(None, None, [])
        self.nbytes = 0
        self.n_nodes = 0
        self._clock = 0
        self.hits = self.misses = 0
        self.evictions = self.invalidations = 0
        self.tokens_saved = 0

    def _touch(self, node: _PrefixNode) -> None:
        self._clock += 1
        node.last_use = self._clock

    def match(self, prompt, max_blocks: int) -> list[_PrefixNode]:
        """Longest cached path over ``prompt``'s aligned blocks, at most
        ``max_blocks`` of them."""
        node, path, a = self.root, [], self.align
        for b in range(max_blocks):
            child = node.children.get(prompt[b * a:(b + 1) * a].tobytes())
            if child is None:
                break
            path.append(child)
            node = child
        for n in path:
            self._touch(n)
        return path

    def insert(self, parent: _PrefixNode, key: bytes,
               segments) -> _PrefixNode:
        node = _PrefixNode(key, parent, segments)
        parent.children[key] = node
        self.nbytes += node.nbytes
        self.n_nodes += 1
        self._touch(node)
        return node

    def evict_to_budget(self) -> int:
        """LRU eviction to the byte budget among childless nodes with no
        refs (an interior node is pinned by its descendants, a refed one
        by its live requests), so eviction cascades leaf first."""
        evicted = 0
        while self.nbytes > self.budget:

            def walk(node, victim=None):
                for child in node.children.values():
                    if not child.children and child.refs <= 0:
                        if (victim is None
                                or child.last_use < victim.last_use):
                            victim = child
                    else:
                        victim = walk(child, victim)
                return victim

            victim = walk(self.root)
            if victim is None:
                break  # everything left is pinned
            del victim.parent.children[victim.key]
            self.nbytes -= victim.nbytes
            self.n_nodes -= 1
            self.evictions += 1
            evicted += 1
        return evicted

    def clear(self) -> tuple:
        """Drop every cached segment (weight swap, close); returns
        ``(nodes, bytes)`` released.  Live requests keep their slot
        copies."""
        n, b = self.n_nodes, self.nbytes
        self.root = _PrefixNode(None, None, [])
        self.n_nodes = 0
        self.nbytes = 0
        self.invalidations += 1
        return n, b


class _Pool:
    """One cache envelope: the device pool (or, paged, the slots' page
    table) and per-slot bookkeeping."""

    __slots__ = ("env", "n_slots", "cache", "state", "reqs", "queue",
                 "prefilling", "table", "table_np", "spec")

    def __init__(self, env: int, n_slots: int):
        self.env = env
        self.n_slots = n_slots
        self.reqs: list[Optional[_Request]] = [None] * n_slots
        self.queue: collections.deque[_Request] = collections.deque()
        # slot -> pending chunk-prefill plan, advanced in insertion order
        # one chunk per pool per step()
        self.prefilling: dict = {}
        self.cache = self.state = self.table = self.table_np = None
        self.spec = None

    def live(self) -> bool:
        return any(r is not None for r in self.reqs)

    def decodable(self) -> bool:
        """At least one occupied slot is past its prefill."""
        return any(r is not None and s not in self.prefilling
                   for s, r in enumerate(self.reqs))


class DecodeEngine:
    """Slot-based continuous-batching server for ``TransformerLM``.

    Args:
      model: a ``TransformerLM`` (served where its weights are), or a
        ``ModelSpec``/config dict built on ``device`` (default
        ``cuda``; raises without a card unless ``device="cpu"``).  GQA,
        ``kv_cache_dtype="int8"`` and the attention spellings compose:
        whole prefills run the model's kernel, every other read of the
        cache is the dense one.
      slots: concurrent requests per bucket (the step's batch).
      buckets: cache envelopes: ``None`` (one pool at ``max_len``), a
        sequence of envelope lengths (``slots`` each), or an
        ``{envelope: slots}`` mapping.
      max_new_tokens / eos_id: per-request defaults (``submit``
        overrides).
      pad_id: prompt padding and post-eos filler.
      prefill_align: prompts are right-padded to this multiple.
      steps_per_sync: decode steps per host sync; admission and
        eviction happen between syncs.
      temperature / top_k / top_p / seed: sampling (0 = greedy); draws
        come from one ``torch.Generator`` seeded with ``seed``.
      queue_bound: per-bucket cap on waiting requests; ``submit``
        raises ``ShedError`` at the bound.
      deadline: default per-request budget in seconds from submit.
      prefix_cache_bytes: byte budget of the shared-prefix KV store
        (``None``: off); ``swap_variables`` invalidates it.
      prefill_chunk: chunked-prefill quantum in tokens (``None``: off; a
        multiple of ``prefill_align``).
      kv_pages: usable device KV pages (``None``: the envelope pools);
        every envelope must be a multiple of ``page_size``.
      page_size: tokens per page (default ``prefill_align``; must equal
        it while ``prefix_cache_bytes`` is set).
      preemption: ``"swap"``, ``"recompute"`` or ``"none"``, the paged
        pool's exhaustion policy.
      recompute_below: under ``"swap"``, victims of at most this many
        tokens (prompt + generated) are recompute-parked instead.
      tenant_quota: per-tenant page cap (int: every tenant; mapping:
        the listed ones; ``None``: off).
      speculative: ``{"proposer": "ngram" | "draft", "k", "ngram",
        "draft_model", "draft_variables"}`` (``None``: off); a draft
        model carries its weights, ``draft_variables`` (its
        ``state_dict`` keys) replace them.  Needs ``temperature=0`` and
        ``steps_per_sync=1``; ``submit(speculative=False)`` opts a
        request out.
    """

    def __init__(self, model, *, slots: int = 8, buckets=None,
                 max_new_tokens: Optional[int] = None,
                 eos_id: Optional[int] = None, pad_id: int = 0,
                 prefill_align: int = 128, steps_per_sync: int = 1,
                 temperature: float = 0.0, top_k: Optional[int] = None,
                 top_p: Optional[float] = None, seed: int = 0,
                 queue_bound: Optional[int] = None,
                 deadline: Optional[float] = None, device=None,
                 prefix_cache_bytes: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 kv_pages: Optional[int] = None,
                 page_size: Optional[int] = None,
                 preemption: str = "swap", recompute_below: int = 0,
                 tenant_quota=None, speculative=None):
        dec = _decode_model(model, device)
        self.dec = dec
        self.max_len = dec.max_len
        self.vocab_size = dec.vocab_size
        if slots < 1:
            raise ValueError(f"slots must be >= 1; got {slots}")
        if prefill_align < 1:
            raise ValueError(
                f"prefill_align must be >= 1; got {prefill_align}")
        if steps_per_sync < 1:
            raise ValueError(
                f"steps_per_sync must be >= 1; got {steps_per_sync}")
        if max_new_tokens is not None and max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1; got {max_new_tokens}")
        for name, tok in (("eos_id", eos_id), ("pad_id", pad_id)):
            if tok is not None and not 0 <= tok < self.vocab_size:
                raise ValueError(
                    f"{name}={tok} outside vocab [0, {self.vocab_size})")
        if top_k is not None and not 1 <= top_k <= self.vocab_size:
            raise ValueError(
                f"top_k={top_k} out of range [1, {self.vocab_size}]")
        if top_p is not None and not 0.0 < top_p <= 1.0:
            raise ValueError(f"top_p={top_p} out of range (0, 1]")
        if queue_bound is not None and queue_bound < 1:
            raise ValueError(
                f"queue_bound must be >= 1 (or None); got {queue_bound}")
        if deadline is not None and deadline <= 0:
            raise ValueError(
                f"deadline must be positive seconds (or None); got "
                f"{deadline}")
        if prefix_cache_bytes is not None and prefix_cache_bytes < 1:
            raise ValueError(
                f"prefix_cache_bytes must be >= 1 (or None); got "
                f"{prefix_cache_bytes}")
        if prefill_chunk is not None and (
                prefill_chunk < prefill_align
                or prefill_chunk % prefill_align):
            raise ValueError(
                f"prefill_chunk={prefill_chunk} must be a positive "
                f"multiple of prefill_align={prefill_align}: chunk "
                "boundaries must land on the padded-shape grid")
        if kv_pages is not None and kv_pages < 1:
            raise ValueError(
                f"kv_pages must be >= 1 (or None); got {kv_pages}")
        if page_size is None:
            page_size = prefill_align
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1; got {page_size}")
        if (kv_pages is not None and prefix_cache_bytes is not None
                and page_size != prefill_align):
            raise ValueError(
                f"page_size={page_size} must equal prefill_align="
                f"{prefill_align} while prefix_cache_bytes is set: "
                "prefix-store segments and KV pages must be the same "
                "shape")
        if preemption not in ("swap", "recompute", "none"):
            raise ValueError(
                f"preemption must be 'swap', 'recompute', or 'none'; "
                f"got {preemption!r}")
        if recompute_below < 0:
            raise ValueError(
                f"recompute_below must be >= 0 tokens; got "
                f"{recompute_below}")
        if tenant_quota is not None and not isinstance(
                tenant_quota, Mapping) and int(tenant_quota) < 1:
            raise ValueError(
                f"tenant_quota must be >= 1 pages (or a mapping, or "
                f"None); got {tenant_quota}")
        spec = _speculative.normalize(
            speculative, vocab_size=self.vocab_size, max_len=self.max_len,
            device=dec.embed.weight.device)
        if spec is not None:
            if float(temperature) != 0.0:
                raise ValueError(
                    "speculative decoding requires temperature=0.0: the "
                    f"acceptance rule is the greedy one; got {temperature}")
            if steps_per_sync != 1:
                raise ValueError(
                    "speculative decoding requires steps_per_sync=1: a "
                    "verify already commits up to k+1 tokens per host "
                    f"sync; got {steps_per_sync}")
        if buckets is None:
            buckets = {self.max_len: slots}
        elif isinstance(buckets, Mapping):
            buckets = dict(buckets)
        else:
            buckets = {int(env): slots for env in buckets}
        if not buckets:
            raise ValueError("buckets must name at least one envelope")
        for env, n in buckets.items():
            if not 0 < env <= self.max_len:
                raise ValueError(
                    f"bucket envelope {env} outside (0, max_len="
                    f"{self.max_len}]")
            if n < 1:
                raise ValueError(f"bucket {env} needs >= 1 slots; got {n}")
            if kv_pages is not None and env % page_size:
                raise ValueError(
                    f"bucket envelope {env} is not a multiple of "
                    f"page_size={page_size}: the paged gather/scatter "
                    "needs a whole number of pages per envelope")
        # the weights every program runs with (functional_call), swapped
        # whole by swap_variables
        self.variables = dict(dec.state_dict())  # guarded-by: _lock
        # chunks and verifies read the slot's cache densely at an offset
        self._dense = copy.copy(dec)
        self._dense.attn, self._dense.attn_fn = "dense", None
        self._dense.flash_attn = self._dense.blockwise_attn = False
        self.max_new_tokens = max_new_tokens
        self.eos_id = eos_id
        self.pad_id = int(pad_id)
        self.prefill_align = int(prefill_align)
        self.steps_per_sync = int(steps_per_sync)
        self.temperature = float(temperature)
        self.top_k = top_k
        self.top_p = top_p
        self.queue_bound = queue_bound
        self.deadline = deadline
        self.device = dec.embed.weight.device
        self._seed = int(seed)
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(self._seed)
        self.prefix_cache_bytes = prefix_cache_bytes
        self.prefill_chunk = (None if prefill_chunk is None
                              else int(prefill_chunk))
        # either lever routes admission through the segmented path
        self._segmented = (prefix_cache_bytes is not None
                           or prefill_chunk is not None)
        self._prefix = (_PrefixStore(self.prefill_align,
                                     int(prefix_cache_bytes))
                        if prefix_cache_bytes is not None else None)
        self.kv_pages = kv_pages
        self.page_size = int(page_size)
        self.preemption = preemption
        self.recompute_below = int(recompute_below)
        self._paged = kv_pages is not None
        self._alloc = (paging.PageAllocator(kv_pages, self.page_size,
                                            tenant_quota)
                       if self._paged else None)
        self._quantized = dec.kv_cache_dtype == "int8"
        # one template slot row: the leaves' dtypes and KVH/D
        self._leaf_tmpl = dec.new_cache(1, 1).leaves()
        self._pages = (paging.build_pool(self._leaf_tmpl, kv_pages,
                                         self.page_size)
                       if self._paged else None)
        self._parked: list = []   # preempted, awaiting readmission
        self._weights_ver = 0  # guarded-by: _lock
        self._spec = spec
        if spec is not None and spec["draft_model"] is not None \
                and spec["draft_variables"] is None:
            spec["draft_variables"] = dict(
                spec["draft_model"].state_dict())
        self._spec_proposed = 0
        self._spec_accepted = 0
        self._n_submitted = 0
        self._inflight: set = set()  # rids queued or in a slot
        # submit() may run on any thread: it serializes the queue, id
        # and dedup mutations against the stepping thread's admission
        # sweep under this lock; step() itself runs on one thread
        self._lock = threading.RLock()
        self._closed = False  # guarded-by: _lock
        self._traces: dict = {}
        self._pools = []
        for env in sorted(buckets):
            pool = _Pool(env, buckets[env])
            self._init_pool(pool)
            self._pools.append(pool)

    # ---- programs -----------------------------------------------------

    def _init_pool(self, pool: _Pool) -> None:
        s, dev = pool.n_slots, self.device
        if self._paged:
            # slots read and write the shared page pool through their
            # table rows (every entry starts at the garbage page)
            pool.table_np = np.zeros((s, pool.env // self.page_size),
                                     np.int32)
            pool.table = torch.zeros(pool.table_np.shape, dtype=torch.long,
                                     device=dev)
        else:
            pool.cache = self.dec.new_cache(s, pool.env)
        pool.state = {
            "tok": torch.full((s,), self.pad_id, dtype=torch.long,
                              device=dev),
            "pos": torch.zeros(s, dtype=torch.long, device=dev),
            "n_left": torch.zeros(s, dtype=torch.long, device=dev),
            "eos": torch.full((s,), -1, dtype=torch.long, device=dev),
            "done": torch.ones(s, dtype=torch.bool, device=dev),
        }
        if self._spec is not None and self._spec["draft_model"] is not None:
            # the draft's own envelope cache: never paged (recompute-
            # class), host mirrors of each slot's feed token and position
            # (dpos -1: rebuild before proposing)
            pool.spec = {
                "cache": self._spec["draft_model"].new_cache(s, pool.env),
                "dtok": np.full((s,), self.pad_id, np.int32),
                "dpos": np.full((s,), -1, np.int32)}

    def _program(self, kind: str, bucket: int, padded=None) -> None:
        """Count a program key the first time the engine runs it (the
        JAX engine's trace-time ``compiles_total``)."""
        key = ((kind, bucket) if padded is None
               else (kind, bucket, padded))
        if key in self._traces:
            return
        self._traces[key] = 1
        labels = {} if padded is None else {"padded": padded}
        telemetry.metrics().counter("compiles_total", kind=kind,
                                    bucket=bucket, **labels).inc()

    def _kind(self, kind: str) -> str:
        return f"paged_{kind}" if self._paged else kind

    def _call(self, variables, model=None):
        model = self.dec if model is None else model
        return lambda *a, **kw: functional_call(model, variables, a, kw)

    def _rows(self, pool: _Pool, slot: Optional[int] = None) -> KVCache:
        """The cache a program runs on, in the envelope layout: one
        slot's rows (``slot``) or the whole bucket.  Envelope mode hands
        out views of the pool; paged mode gathers the slots' pages into
        fresh tensors that ``_put_rows`` scatters back."""
        if not self._paged:
            return (pool.cache if slot is None
                    else pool.cache.rows(slot, slot + 1))
        table = pool.table if slot is None else pool.table[slot:slot + 1]
        return KVCache.from_leaves(paging.gather_cache(self._pages, table),
                                   self._quantized)

    def _put_rows(self, pool: _Pool, cache: KVCache,
                  slot: Optional[int] = None) -> None:
        if self._paged:
            table = (pool.table if slot is None
                     else pool.table[slot:slot + 1])
            paging.scatter_cache(self._pages, cache.leaves(), table)

    def _set_slot_state(self, pool: _Pool, slot: int, **vals) -> None:
        for k, v in vals.items():
            pool.state[k][slot] = v

    @torch.no_grad()
    def _run_prefill(self, pool: _Pool, slot: int, prompt: np.ndarray,
                     n_left0: int, eos: int, variables) -> int:
        """The whole-prompt prefill: the slot's envelope replaced by the
        right-padded prompt's K/V (through the model's kernel at
        128-aligned lengths), its decode state installed; returns the
        first token."""
        t_p = len(prompt)
        t_pad = min(pool.env, _ceil_to(t_p, self.prefill_align))
        self._program(self._kind("prefill"), pool.env, t_pad)
        rows = self._rows(pool, slot)
        for t in rows.leaves():
            t.zero_()
        toks = torch.as_tensor(prompt, dtype=torch.long,
                               device=self.device)[None]
        logits = prefill(self._call(variables), toks, rows,
                         align=self.prefill_align, pad_id=self.pad_id)
        tok0 = _select(logits, self.temperature, self.top_k, self.top_p,
                       self._generator)[0]
        self._put_rows(pool, rows, slot)
        done0 = (n_left0 <= 0) | ((eos >= 0) & (tok0 == eos))
        self._set_slot_state(pool, slot, tok=tok0, pos=t_p, n_left=n_left0,
                             eos=eos, done=done0)
        return int(tok0)

    @torch.no_grad()
    def _run_chunk(self, pool: _Pool, slot: int, chunk: np.ndarray,
                   start: int, last_rel: int, final: bool, n_left0: int,
                   eos: int, variables) -> int:
        """One prefill chunk appended at rows ``[start, start + T)``
        through the dense read (exact at any offset: rows at and after
        ``start`` stay masked until this call writes them).  Only the
        final chunk installs the slot's state; until then the slot is
        ``done`` with its dead-write row at ``env - 1``."""
        self._program(self._kind("chunk_prefill"), pool.env,
                      chunk.shape[1])
        rows = self._rows(pool, slot)
        rows.index = start
        logits, _ = self._call(variables, self._dense)(
            torch.as_tensor(chunk, dtype=torch.long, device=self.device),
            cache=rows, last_index=last_rel)
        tok0 = _select(logits[:, -1].float(), self.temperature, self.top_k,
                       self.top_p, self._generator)[0]
        self._put_rows(pool, rows, slot)
        if final:
            done0 = (n_left0 <= 0) | ((eos >= 0) & (tok0 == eos))
            self._set_slot_state(pool, slot, tok=tok0,
                                 pos=start + last_rel + 1,
                                 n_left=n_left0, eos=eos, done=done0)
        else:
            self._set_slot_state(pool, slot, tok=self.pad_id,
                                 pos=pool.env - 1, n_left=0, eos=-1,
                                 done=True)
        return int(tok0)

    @torch.no_grad()
    def _run_verify(self, pool: _Pool, slot: int, chunk: np.ndarray,
                    start: int, variables) -> np.ndarray:
        """The speculative verify: one dense pass over ``[last committed
        token, proposals...]`` at the slot's offset, every position's
        greedy token back.  Rejected rows stay written and are rolled
        back by the position rewind (write before read)."""
        self._program(self._kind("verify"), pool.env, chunk.shape[1])
        rows = self._rows(pool, slot)
        rows.index = start
        logits, _ = self._call(variables, self._dense)(
            torch.as_tensor(chunk, dtype=torch.long, device=self.device),
            cache=rows, logits_all=True)
        self._put_rows(pool, rows, slot)
        return torch.argmax(logits[0].float(), dim=-1).cpu().numpy()

    @torch.no_grad()
    def _run_step(self, pool: _Pool, variables):
        """``steps_per_sync`` T=1 steps over every slot of ``pool``;
        returns host ``toks``/``was_done`` ``[steps, slots]``: a token is
        real iff its slot was live entering that step."""
        self._program(self._kind("step"), pool.env)
        cache = self._rows(pool)
        call = self._call(variables)
        st = pool.state
        toks, was_done = [], []
        for _ in range(self.steps_per_sync):
            fin = st["done"]
            # done slots re-write their last row (dead data, kept in
            # range so live rows never see the overflow poison)
            step_pos = st["pos"].clamp(max=pool.env - 1)
            nxt = decode_step(call, cache, st["tok"], slot_pos=step_pos,
                              temperature=self.temperature,
                              top_k=self.top_k, top_p=self.top_p,
                              generator=self._generator)
            eos_hit = (st["eos"] >= 0) & (nxt == st["eos"])
            nxt = torch.where(fin, torch.full_like(nxt, self.pad_id), nxt)
            n_left = torch.where(fin, st["n_left"], st["n_left"] - 1)
            st = {"tok": nxt,
                  "pos": torch.where(fin, st["pos"], st["pos"] + 1),
                  "n_left": n_left,
                  "eos": st["eos"],
                  "done": fin | eos_hit | (n_left <= 0)}
            toks.append(nxt)
            was_done.append(fin)
        self._put_rows(pool, cache)
        pool.state = st
        return (torch.stack(toks).cpu().numpy(),
                torch.stack(was_done).cpu().numpy())

    @torch.no_grad()
    def _prefix_install(self, pool: _Pool, slot: int, req: _Request,
                        path: list) -> None:
        """Copy the matched blocks into the slot (zero model FLOPs):
        paged, block ``b`` goes straight into the request's page ``b``."""
        align = self.prefill_align
        for b, node in enumerate(path):
            if self._paged:
                self._program("page_copy", self.page_size)
                pid = req.pages[b]
                for p, s in zip(self._pages, node.segments):
                    p[pid] = s[0]
            else:
                self._program("prefix_copy", pool.env)
                for leaf, s in zip(pool.cache.leaves(), node.segments):
                    leaf[slot:slot + 1, :, b * align:(b + 1) * align] = s

    @torch.no_grad()
    def _prefix_extract(self, pool: _Pool, slot: int, req: _Request,
                        b: int) -> list:
        """Block ``b`` of a slot's cache as fresh store segments."""
        if self._paged:
            self._program("page_extract", self.page_size)
            return [p[req.pages[b]][None].clone() for p in self._pages]
        self._program("prefix_extract", pool.env)
        a = self.prefill_align
        return [leaf[slot:slot + 1, :, b * a:(b + 1) * a].clone()
                for leaf in pool.cache.leaves()]

    # ---- admission ----------------------------------------------------

    def _route(self, t_p: int, max_new: int) -> _Pool:
        for pool in self._pools:  # ascending envelopes
            t_pad = min(pool.env, _ceil_to(t_p, self.prefill_align))
            if t_p <= t_pad <= pool.env and t_p + max_new <= pool.env:
                return pool
        raise ValueError(
            f"prompt length {t_p} + max_new_tokens {max_new} fits no "
            f"bucket (envelopes {[p.env for p in self._pools]}, "
            f"max_len={self.max_len})")

    def submit(self, prompt, *, max_new_tokens: Optional[int] = None,
               eos_id=_UNSET, request_id=None, deadline=_UNSET,
               meta: Optional[Mapping] = None, tenant=None,
               priority: int = 1, speculative=None):
        """Queue one request; returns its id (auto-assigned if None).

        The request fails HERE if it fits no bucket (or, paged, needs
        more pages at its longest than the pool or its tenant's quota
        holds).  A ``request_id`` still in flight is rejected; with
        ``queue_bound`` set, a full queue sheds the request
        (``ShedError``).  ``tenant``/``priority`` (0..2) are the paged
        QoS keys (inert on the envelope pools); ``speculative=False``
        opts the request out of speculation, ``True`` needs an engine
        built with it."""
        if self._closed:
            raise RuntimeError("engine is closed; submit after close()")
        prompt = np.asarray(prompt, np.int32)
        if prompt.ndim != 1 or len(prompt) < 1:
            raise ValueError(
                f"prompt must be a 1-D token-id array; got shape "
                f"{prompt.shape}")
        max_new = (self.max_new_tokens if max_new_tokens is None
                   else max_new_tokens)
        if max_new is None or max_new < 1:
            raise ValueError(
                "max_new_tokens must be >= 1 (set per request or as "
                f"the engine default); got {max_new}")
        eos = self.eos_id if eos_id is _UNSET else eos_id
        if eos is not None and not 0 <= eos < self.vocab_size:
            raise ValueError(
                f"eos_id={eos} outside vocab [0, {self.vocab_size})")
        dl = self.deadline if deadline is _UNSET else deadline
        if dl is not None and dl <= 0:
            raise ValueError(
                f"deadline must be positive seconds (or None); got {dl}")
        if not isinstance(priority, int) or not 0 <= priority <= 2:
            raise ValueError(
                f"priority must be an int in 0..2; got {priority!r}")
        if speculative and self._spec is None:
            raise ValueError(
                "submit(speculative=True) needs an engine built with "
                "speculative=...; this engine has speculation off")
        pool = self._route(len(prompt), max_new)
        if self._paged:
            t_p = len(prompt)
            t_pad = min(pool.env, _ceil_to(t_p, self.prefill_align))
            need = max(paging.pages_for(t_pad, self.page_size),
                       paging.pages_for(min(pool.env, t_p + max_new),
                                        self.page_size))
            if need > self.kv_pages:
                raise ValueError(
                    f"request needs {need} KV pages at its max length "
                    f"but the pool has kv_pages={self.kv_pages}")
            quota = self._alloc.quota_for(tenant)
            if quota is not None and need > quota:
                raise ValueError(
                    f"request needs {need} KV pages at its max length "
                    f"but tenant {tenant!r} has a tenant_quota of {quota}")
        m = telemetry.metrics()
        with self._lock:
            if self._closed:
                raise RuntimeError("engine is closed; submit after close()")
            if (self.queue_bound is not None
                    and len(pool.queue) >= self.queue_bound):
                m.counter("serving_shed_total", reason="queue_full",
                          bucket=pool.env).inc()
                flight_recorder.record("shed", reason="queue_full",
                                       bucket=pool.env)
                raise ShedError(
                    "queue_full",
                    f"bucket {pool.env} admission queue at its bound "
                    f"({self.queue_bound} waiting); request shed — "
                    "resubmit after draining")
            if request_id is None:
                rid = self._n_submitted
                while rid in self._inflight:  # skip in-flight ids
                    rid += 1
            else:
                rid = request_id
                if rid in self._inflight:
                    raise ValueError(
                        f"request_id {rid!r} is already in flight; "
                        "duplicate ids would cross-deliver results")
            req = _Request(rid, prompt, int(max_new), eos,
                           dict(meta or {}), self._n_submitted,
                           deadline=dl, tenant=tenant, priority=priority)
            if speculative is not None:
                req.spec_on = bool(speculative)
            self._n_submitted += 1
            self._inflight.add(rid)
            pool.queue.append(req)
            m.counter("serving_requests_total", bucket=pool.env).inc()
            m.gauge("serving_queue_depth",
                    bucket=pool.env).set(len(pool.queue))
            return req.rid

    def reset_rng(self) -> None:
        """Rewind the sampling stream so a replayed workload draws the
        same tokens (only while the engine is idle)."""
        if self.has_work():
            raise RuntimeError(
                "reset_rng with requests in flight would replay draws "
                "mid-stream; drain the engine first")
        self._generator.manual_seed(self._seed)

    def swap_variables(self, variables: Mapping) -> None:
        """Hot weight swap: install a new weights mapping (the model's
        ``state_dict`` keys, shapes and dtypes; ``convert.params_from_
        flax`` turns a JAX tree into one; a mismatch raises
        ``ValueError``).  Nothing is copied into the model: every
        program runs through ``functional_call`` on the dict that
        ``step()`` snapshots once per call, so the swap lands at the
        next step boundary and a step running on another thread keeps
        the old weights.  Live slots keep their KV (a mid-request swap
        serves a hybrid prefix); the prefix store is cleared, every
        slot's draft cache invalidated, and a request admitted under the
        old weights never donates its blocks."""
        if self._closed:
            raise RuntimeError("engine is closed; swap after close()")
        new = dict(variables)
        old = self.variables
        if set(new) != set(old):
            raise ValueError(
                "swap_variables structure mismatch: missing "
                f"{sorted(set(old) - set(new))[:4]}, unknown "
                f"{sorted(set(new) - set(old))[:4]}")
        staged = {}
        for name, o in old.items():
            n = new[name]
            if isinstance(n, torch.Tensor):
                n_sh, n_dt = tuple(n.shape), n.dtype
            else:
                arr = np.asarray(n)
                n_sh = tuple(arr.shape)
                n_dt = _TORCH_DTYPES.get(str(arr.dtype))
                n = _as_tensor(arr, "cpu") if n_dt else None
            if n_sh != tuple(o.shape) or n_dt != o.dtype:
                raise ValueError(
                    f"swap_variables leaf {name!r} mismatch: engine has "
                    f"{tuple(o.shape)}/{o.dtype}, got {n_sh}/{n_dt}")
            staged[name] = n.detach().to(o.device, copy=True)
        inval = None
        with self._lock:
            self.variables = staged
            # in-flight requests whose KV was (partly) computed under the
            # old weights must not donate it back
            self._weights_ver += 1
            if self._prefix is not None:
                inval = self._prefix.clear()
            # no draft proposal spans the swap boundary
            for pool in self._pools:
                for slot in range(pool.n_slots):
                    self._draft_invalidate(pool, slot)
        telemetry.metrics().counter("serving_weight_swaps_total").inc()
        telemetry.instant("weight_swap")
        flight_recorder.record("weight_swap", leaves=len(staged))
        if inval is not None:
            n_nodes, n_bytes = inval
            telemetry.metrics().counter(
                "serving_prefix_invalidations_total").inc()
            telemetry.instant("prefix_invalidate", nodes=n_nodes,
                              bytes=n_bytes)
            flight_recorder.record("prefix_invalidate", nodes=n_nodes,
                                   bytes=n_bytes, reason="weight_swap")

    def _note_gauges(self, pool: _Pool) -> None:
        """Per-bucket queue-depth and slot-occupancy gauges."""
        m = telemetry.metrics()
        m.gauge("serving_queue_depth", bucket=pool.env).set(len(pool.queue))
        m.gauge("serving_slot_occupancy", bucket=pool.env).set(
            sum(r is not None for r in pool.reqs))
        if self._paged:
            m.gauge("serving_free_pages").set(self._alloc.n_free)

    def _shed_expired_queued(self, pool: _Pool) -> list[dict]:
        """Queued requests past their deadline leave with an ``error``
        result instead of taking a prefill and a slot."""
        with self._lock:
            if not any(r.deadline is not None for r in pool.queue):
                return []
            now = telemetry.now()
            expired, alive = [], collections.deque()
            for req in pool.queue:
                (expired if req.deadline is not None
                 and now > req.deadline else alive).append(req)
            pool.queue = alive
        m = telemetry.metrics()
        out = []
        for req in expired:
            m.counter("serving_shed_total", reason="deadline",
                      bucket=pool.env).inc()
            out.append(self._finish_error(req, "deadline_exceeded",
                                          pool.env))
        return out

    # ---- paged-mode QoS: pages, preemption, readmission ---------------

    def _pages_needed(self, t_p: int, pool: _Pool) -> int:
        """Initial page footprint: the padded prefill length (pad rows
        land in real pages, so the whole prefill scatter is backed)."""
        t_pad = min(pool.env, _ceil_to(t_p, self.prefill_align))
        return paging.pages_for(t_pad, self.page_size)

    def _alloc_pages(self, n: int, tenant) -> Optional[list]:
        pids = self._alloc.alloc(n, tenant)
        if pids:
            telemetry.metrics().counter(
                "serving_pages_allocated_total").inc(len(pids))
        return pids

    def _release_pages(self, req: _Request, pool: _Pool = None,
                       slot: Optional[int] = None) -> None:
        """Return a request's pages and (when it held a slot) point its
        table row back at the garbage page; drops any parked host KV.
        Idempotent: every terminal path funnels through here."""
        if self._paged and req.pages:
            self._alloc.free(req.pages, req.tenant)
            telemetry.metrics().counter(
                "serving_pages_freed_total").inc(len(req.pages))
            req.pages = []
        req.swap = None
        if pool is not None and slot is not None and self._paged \
                and pool.table_np is not None:
            self._set_table_row(pool, slot, [])

    def _set_table_row(self, pool: _Pool, slot: int, pages: list) -> None:
        pool.table_np[slot] = 0
        pool.table_np[slot, :len(pages)] = pages
        pool.table[slot] = torch.from_numpy(
            pool.table_np[slot].astype(np.int64)).to(self.device)

    def _pick_queued(self, pool: _Pool) -> Optional[_Request]:
        """Highest priority class first, FIFO within a class; requests
        blocked by their tenant's quota stay queued."""
        with self._lock:
            best = None
            for req in pool.queue:
                if not self._alloc.fits_quota(
                        self._pages_needed(len(req.prompt), pool),
                        req.tenant):
                    continue
                key = (-req.priority, req.submit_order)
                if best is None or key < best[0]:
                    best = (key, req)
            if best is None:
                return None
            pool.queue.remove(best[1])
            return best[1]

    def _pick_victim(self, below: int, exclude=None):
        """The lowest-priority live decodable request strictly below
        ``below`` (latest submitted first within a class); mid-prefill
        slots are never preempted."""
        best = None
        for pool in self._pools:
            for slot, req in enumerate(pool.reqs):
                if (req is None or slot in pool.prefilling
                        or req is exclude or req.priority >= below):
                    continue
                key = (req.priority, -req.submit_order)
                if best is None or key < best[0]:
                    best = (key, pool, slot)
        return None if best is None else (best[1], best[2])

    @torch.no_grad()
    def _preempt(self, pool: _Pool, slot: int, reason: str) -> None:
        """Evict a live request without finishing it: its pages to host
        memory (``"swap"``) or a recompute plan, its pages freed, the
        request parked for readmission.  A swap restore is page-exact,
        so the tokens are those of an uninterrupted run."""
        req = pool.reqs[slot]
        ctx = len(req.prompt) + len(req.tokens)
        mode = ("recompute" if self.preemption == "recompute"
                or ctx <= self.recompute_below else "swap")
        m = telemetry.metrics()
        if mode == "swap":
            with telemetry.span("page_swap", direction="out",
                                request_id=req.rid, pages=len(req.pages)):
                idx = torch.as_tensor(req.pages, dtype=torch.long,
                                      device=self.device)
                host = [leaf[idx].cpu() for leaf in self._pages]
                st = {k: v[slot].item() for k, v in pool.state.items()}
            req.swap = {"mode": "swap", "pool": pool, "pages": host,
                        "state": st, "ver": req.weights_ver}
            m.counter("serving_pages_swapped_total").inc(len(req.pages))
        else:
            req.swap = {"mode": "recompute", "pool": pool}
        pool.reqs[slot] = None
        # draft KV is recompute-class: never part of the swap plan
        self._draft_invalidate(pool, slot)
        # a parked request re-matches the store at readmission
        self._prefix_unpin(req)
        swap_plan = req.swap  # _release_pages clears it
        self._release_pages(req, pool, slot)
        req.swap = swap_plan
        self._parked.append(req)
        m.counter("serving_preemptions_total", reason=reason).inc()
        telemetry.instant("preempt", bucket=pool.env, slot=slot,
                          request_id=req.rid, mode=mode)
        flight_recorder.record("preempt", request_id=req.rid,
                               bucket=pool.env, reason=reason, mode=mode)

    def _reserve_pages(self, req: _Request, n: int) -> bool:
        """``n`` pages for an arriving or readmitted request, preempting
        strictly lower-priority live requests while the pool is short
        (a quota shortfall never preempts)."""
        if not self._alloc.fits_quota(n, req.tenant):
            return False
        pids = self._alloc_pages(n, req.tenant)
        while pids is None and self.preemption != "none":
            victim = self._pick_victim(below=req.priority)
            if victim is None:
                return False
            self._preempt(*victim, reason="admission")
            pids = self._alloc_pages(n, req.tenant)
        if pids is None:
            return False
        req.pages = pids
        return True

    def _sweep_parked(self) -> list[dict]:
        """A parked request past its deadline expires as a queued one
        does."""
        out = []
        if not self._parked:
            return out
        now = telemetry.now()
        m = telemetry.metrics()
        for req in list(self._parked):
            if req.deadline is not None and now > req.deadline:
                self._parked.remove(req)
                env = req.swap["pool"].env
                self._release_pages(req)
                m.counter("serving_shed_total", reason="deadline",
                          bucket=env).inc()
                out.append(self._finish_error(req, "deadline_exceeded",
                                              env))
        return out

    @torch.no_grad()
    def _readmit_parked(self, variables) -> list[dict]:
        """Parked requests re-enter (highest priority first, FIFO within
        a class) when their pool has a free slot and the pages fit.  A
        swap restore is page-exact; a weight swap since the preemption
        makes the saved KV stale, so such a request recomputes from
        prompt and generated tokens under the new weights."""
        out = []
        if not self._parked:
            return out
        m = telemetry.metrics()
        for req in sorted(self._parked,
                          key=lambda r: (-r.priority, r.submit_order)):
            pool = req.swap["pool"]
            slot = next((s for s in range(pool.n_slots)
                         if pool.reqs[s] is None
                         and s not in pool.prefilling), None)
            if slot is None:
                continue
            if req.deadline is not None and telemetry.now() > req.deadline:
                self._parked.remove(req)
                self._release_pages(req)
                m.counter("serving_shed_total", reason="deadline",
                          bucket=pool.env).inc()
                out.append(self._finish_error(req, "deadline_exceeded",
                                              pool.env))
                continue
            mode = req.swap["mode"]
            if mode == "swap" and req.swap["ver"] != self._weights_ver:
                mode = "recompute"  # stale KV, as the prefix store's
            if mode == "swap":
                n = req.swap["pages"][0].shape[0]
            else:
                n = self._pages_needed(len(req.prompt) + len(req.tokens),
                                       pool)
            if not self._reserve_pages(req, n):
                continue  # stays parked; retried next sweep
            self._parked.remove(req)
            m.counter("serving_readmissions_total").inc()
            flight_recorder.record("readmit", request_id=req.rid,
                                   bucket=pool.env, mode=mode, pages=n)
            if mode == "swap":
                swap, req.swap = req.swap, None
                self._set_table_row(pool, slot, req.pages)
                with telemetry.span("page_swap", direction="in",
                                    request_id=req.rid, pages=n):
                    idx = torch.as_tensor(req.pages, dtype=torch.long,
                                          device=self.device)
                    for leaf, h in zip(self._pages, swap["pages"]):
                        leaf[idx] = h.to(self.device)
                    self._set_slot_state(pool, slot, **swap["state"])
                pool.reqs[slot] = req
                # the target restore is page-exact; the slot's draft
                # cache is whatever its last tenant left
                self._draft_invalidate(pool, slot)
            else:
                req.swap = None
                req.weights_ver = self._weights_ver
                # past its envelope a request rolled over row env-1;
                # recompute keeps the ledger's most recent env tokens
                out.extend(self._prefill_whole(
                    pool, slot, req, variables,
                    prompt_override=req.ledger(pool.env)))
            self._note_gauges(pool)
        return out

    def _grow_pages(self, pool: _Pool) -> list[dict]:
        """Before a decode quantum, extend every live slot's pages to
        cover the rows it will write (``pos + steps_per_sync``, capped
        at the envelope and the remaining budget).  Exhaustion preempts
        a strictly lower-priority victim, else parks the grower itself
        (or, with preemption off, sheds it with
        ``error="kv_pages_exhausted"``)."""
        out = []
        page = self.page_size
        m = telemetry.metrics()
        for slot in range(pool.n_slots):
            req = pool.reqs[slot]
            if req is None or slot in pool.prefilling:
                continue
            # host mirror of the device pos: prompt + generated - 1
            pos = len(req.prompt) + max(0, len(req.tokens) - 1)
            live = min(self.steps_per_sync, req.max_new - len(req.tokens))
            need = paging.pages_for(min(pool.env, pos + live), page)
            changed = False
            while len(req.pages) < need:
                blocked_quota = not self._alloc.fits_quota(1, req.tenant)
                pids = (None if blocked_quota
                        else self._alloc_pages(1, req.tenant))
                if pids is not None:
                    req.pages.extend(pids)
                    changed = True
                    continue
                if not blocked_quota and self.preemption != "none":
                    victim = self._pick_victim(below=req.priority,
                                               exclude=req)
                    if victim is not None:
                        self._preempt(*victim, reason="growth")
                        continue
                if self.preemption == "none":
                    pool.reqs[slot] = None
                    self._release_pages(req, pool, slot)
                    m.counter("serving_shed_total", reason="kv_pages",
                              bucket=pool.env).inc()
                    out.append(self._finish_error(
                        req, "kv_pages_exhausted", pool.env))
                else:
                    # no lower-priority victim (or quota): park itself
                    self._preempt(pool, slot,
                                  reason=("quota" if blocked_quota
                                          else "growth"))
                changed = False
                break
            if changed:
                self._set_table_row(pool, slot, req.pages)
        return out

    def free_pages(self) -> Optional[int]:
        """Free device KV pages now (``None``: envelope mode); safe from
        any thread."""
        return self._alloc.n_free if self._paged else None

    def paging_stats(self) -> dict:
        """Host-side paging and QoS counters."""
        if not self._paged:
            return {"enabled": False}
        return {"enabled": True, "parked": len(self._parked),
                "preemption": self.preemption, **self._alloc.stats()}

    # ---- admission sweep ----------------------------------------------

    def _admit(self) -> list[dict]:
        finished = []
        # one weights snapshot per admission sweep: a concurrent swap
        # lands at the next step boundary, never mid-sweep
        variables = self.variables
        if self._paged:
            finished.extend(self._sweep_parked())
            finished.extend(self._readmit_parked(variables))
        for pool in self._pools:
            finished.extend(self._shed_expired_queued(pool))
            for slot in range(pool.n_slots):
                if pool.reqs[slot] is not None:
                    continue
                if self._paged:
                    req = self._pick_queued(pool)
                    if req is None:
                        break
                    if not self._reserve_pages(
                            req, self._pages_needed(len(req.prompt), pool)):
                        with self._lock:  # wait at the head, in order
                            pool.queue.appendleft(req)
                        break
                else:
                    with self._lock:  # pop vs racing submit() appends
                        if not pool.queue:
                            break
                        req = pool.queue.popleft()
                admit = (self._admit_segmented if self._segmented
                         else self._prefill_whole)
                finished.extend(admit(pool, slot, req, variables))
            self._note_gauges(pool)
        return finished

    def _prefill_whole(self, pool: _Pool, slot: int, req: _Request,
                       variables, prompt_override=None) -> list[dict]:
        """The one-shot prefill of the whole padded prompt.
        ``prompt_override`` is the recompute readmission: the prompt
        plus every token generated before the preemption, with the
        budget continuing where the request left off.  A prefill that
        raises ends this request alone as an ``error`` result."""
        m = telemetry.metrics()
        self._draft_invalidate(pool, slot)  # new slot tenant
        # the weights this KV is computed under: a swap-parked request
        # restores page-exact only under the same ones (the JAX engine
        # stamps segmented admissions only, so its one-shot admissions
        # recompute on readmission)
        req.weights_ver = self._weights_ver
        prompt = req.prompt if prompt_override is None else prompt_override
        t_pad = min(pool.env, _ceil_to(len(prompt), self.prefill_align))
        # generation budget left AFTER this prefill's token
        n_left0 = req.max_new - len(req.tokens) - 1
        try:
            with telemetry.span("prefill", bucket=pool.env, slot=slot,
                                padded=t_pad, request_id=req.rid):
                if self._paged:
                    self._set_table_row(pool, slot, req.pages)
                tok0 = self._run_prefill(
                    pool, slot, prompt, n_left0,
                    -1 if req.eos_id is None else req.eos_id, variables)
                req.tokens.append(tok0)
        except Exception as e:
            # per-request isolation: the slot stays free, the neighbours
            # keep decoding
            self._release_pages(req, pool, slot)
            return [self._finish_error(req, f"prefill_failed: {e!r}",
                                       pool.env)]
        req.t_first = req.t_first or telemetry.now()
        req.t_last_tok = telemetry.now()
        req.traces_seen = sum(self._traces.values())
        m.counter("serving_tokens_total", bucket=pool.env).inc()
        pool.reqs[slot] = req
        if len(req.tokens) >= req.max_new or req.tokens[-1] == req.eos_id:
            return [self._finish(pool, slot)]
        return []

    def _admit_segmented(self, pool: _Pool, slot: int, req: _Request,
                         variables) -> list[dict]:
        """Prefix-cache and chunked admission: install the longest
        cached prefix by copy, then plan the uncached tail as chunks
        (advanced by ``step()``, one per pool per call).  An uncached
        prompt with chunking off takes the one-shot prefill."""
        m = telemetry.metrics()
        self._draft_invalidate(pool, slot)  # new slot tenant
        t_p = len(req.prompt)
        t_pad = min(pool.env, _ceil_to(t_p, self.prefill_align))
        align = self.prefill_align
        start = 0
        if self._prefix is not None:
            store = self._prefix
            path = store.match(req.prompt, (t_p - 1) // align)
            if path:
                start = len(path) * align
                try:
                    with telemetry.span("prefix_copy", bucket=pool.env,
                                        slot=slot, rows=start,
                                        request_id=req.rid):
                        self._prefix_install(pool, slot, req, path)
                except Exception as e:
                    self._release_pages(req, pool, slot)
                    return [self._finish_error(
                        req, f"prefill_failed: {e!r}", pool.env)]
                for node in path:   # pin: LRU must not evict under us
                    node.refs += 1
                req.prefix_path = tuple(path)
                store.hits += 1
                store.tokens_saved += start
                m.counter("serving_prefix_hits_total",
                          bucket=pool.env).inc()
                m.counter("serving_prefill_tokens_saved_total",
                          bucket=pool.env).inc(start)
            else:
                store.misses += 1
                m.counter("serving_prefix_misses_total",
                          bucket=pool.env).inc()
            m.gauge("serving_prefix_hit_rate").set(
                store.hits / (store.hits + store.misses))
        req.weights_ver = self._weights_ver
        if start == 0 and self.prefill_chunk is None:
            return self._prefill_whole(pool, slot, req, variables)
        padded = np.full((1, t_pad), self.pad_id, np.int32)
        padded[0, :t_p] = req.prompt
        quantum = self.prefill_chunk or (t_pad - start)
        chunks = []
        for c0 in range(start, t_pad, quantum):
            c1 = min(c0 + quantum, t_pad)
            final = c1 == t_pad
            # the true last token always lands in the final chunk
            last_rel = (t_p - 1 - c0) if final else (c1 - c0 - 1)
            chunks.append((c0, padded[:, c0:c1], last_rel, final))
        pool.reqs[slot] = req
        if self._paged:  # chunk writes are page-backed from chunk 0
            self._set_table_row(pool, slot, req.pages)
        pool.prefilling[slot] = {"req": req, "chunks": chunks, "next": 0}
        if self.prefill_chunk is None:
            # prefix-only: the single tail program runs now
            return self._advance_prefill(pool, slot, variables)
        return []

    def _advance_prefill(self, pool: _Pool, slot: int,
                         variables) -> list[dict]:
        """Run ONE pending prefill chunk for ``slot``, after re-checking
        the request's deadline."""
        plan = pool.prefilling[slot]
        req = plan["req"]
        m = telemetry.metrics()
        if req.deadline is not None and telemetry.now() > req.deadline:
            pool.reqs[slot] = None
            del pool.prefilling[slot]
            self._release_pages(req, pool, slot)
            m.counter("serving_shed_total", reason="deadline",
                      bucket=pool.env).inc()
            telemetry.instant("evict", bucket=pool.env, slot=slot,
                              request_id=req.rid)
            return [self._finish_error(req, "deadline_exceeded", pool.env)]
        c0, chunk, last_rel, final = plan["chunks"][plan["next"]]
        try:
            with telemetry.span("prefill_chunk", bucket=pool.env,
                                slot=slot, start=c0, size=chunk.shape[1],
                                final=final, request_id=req.rid):
                tok0 = self._run_chunk(
                    pool, slot, chunk, c0, last_rel, final,
                    req.max_new - 1,
                    -1 if req.eos_id is None else req.eos_id, variables)
                if final:
                    req.tokens.append(tok0)
        except Exception as e:
            pool.reqs[slot] = None
            del pool.prefilling[slot]
            self._release_pages(req, pool, slot)
            return [self._finish_error(req, f"prefill_failed: {e!r}",
                                       pool.env)]
        plan["next"] += 1
        if not final:
            return []
        del pool.prefilling[slot]
        req.t_first = telemetry.now()
        req.t_last_tok = req.t_first
        req.traces_seen = sum(self._traces.values())
        m.counter("serving_tokens_total", bucket=pool.env).inc()
        if req.max_new == 1 or req.tokens[-1] == req.eos_id:
            return [self._finish(pool, slot)]
        return []

    def _prefix_unpin(self, req: _Request) -> None:
        """Release the request's refs on its matched path (idempotent)."""
        for node in req.prefix_path:
            node.refs -= 1
        req.prefix_path = ()

    def _donate_prefix(self, pool: _Pool, slot: int,
                       req: _Request) -> None:
        """Donate the finished request's whole prompt blocks not cached
        yet to the store, then evict to the byte budget.  Best effort: a
        failure here never fails the request."""
        store = self._prefix
        align = self.prefill_align
        n = min(len(req.prompt) // align, pool.env // align)
        if self._paged:
            # page_size == prefill_align: block b lives in req.pages[b]
            n = min(n, len(req.pages))
        inserted = False
        try:
            node = store.root
            for b in range(n):
                key = req.prompt[b * align:(b + 1) * align].tobytes()
                child = node.children.get(key)
                if child is None:
                    child = store.insert(
                        node, key, self._prefix_extract(pool, slot, req, b))
                    inserted = True
                else:
                    store._touch(child)
                node = child
        except Exception:
            return
        if inserted:
            evicted = store.evict_to_budget()
            if evicted:
                telemetry.metrics().counter(
                    "serving_prefix_evictions_total").inc(evicted)

    def prefix_stats(self) -> dict:
        """Host-side prefix-store counters."""
        if self._prefix is None:
            return {"enabled": False}
        s = self._prefix
        return {"enabled": True, "hits": s.hits, "misses": s.misses,
                "evictions": s.evictions, "invalidations": s.invalidations,
                "tokens_saved": s.tokens_saved, "nodes": s.n_nodes,
                "bytes": s.nbytes, "budget_bytes": s.budget}

    # ---- disaggregated prefill/decode interchange ---------------------
    #
    # The store mutators below run on the stepping thread only.

    def match_blocks(self, prompt) -> int:
        """How many leading whole ``prefill_align`` blocks of ``prompt``
        the local prefix store holds."""
        if self._prefix is None:
            return 0
        prompt = np.ascontiguousarray(prompt, np.int32)
        return len(self._prefix.match(prompt,
                                      len(prompt) // self.prefill_align))

    def export_prefix(self, prompt) -> Optional[dict]:
        """``prompt``'s cached prefix blocks as host tensors:
        ``{"prompt", "n_blocks", "weights_ver", "blocks"}`` (``blocks[b]``
        block ``b``'s segment leaves in the flax flatten order), or
        ``None`` when nothing is cached.  ``pack_kv_blocks`` puts it on
        the wire."""
        if self._prefix is None:
            return None
        prompt = np.ascontiguousarray(prompt, np.int32)
        path = self._prefix.match(prompt, len(prompt) // self.prefill_align)
        if not path:
            return None
        blocks = [[s.cpu() for s in n.segments] for n in path]
        return {"prompt": prompt, "n_blocks": len(blocks),
                "weights_ver": self._weights_ver, "blocks": blocks}

    def import_prefix(self, prompt, blocks,
                      weights_ver: Optional[int] = None) -> int:
        """Install a shipped block set (host tensors, or numpy arrays as
        the JAX engine exports them) into the local prefix store;
        admission then takes the ordinary prefix-hit path.  Returns the
        number of blocks newly installed.  A ``weights_ver`` other than
        the engine's is a stale export, rejected whole (0); segments of
        another shape or dtype than this engine's raise ``ValueError``."""
        if self._prefix is None or not blocks:
            return 0
        if weights_ver is not None and weights_ver != self._weights_ver:
            return 0
        store = self._prefix
        prompt = np.ascontiguousarray(prompt, np.int32)
        align = self.prefill_align
        want = [(t.dtype, (1, t.shape[1], align, t.shape[3]))
                for t in self._leaf_tmpl]
        installed = 0
        node = store.root
        for b, segs in enumerate(blocks):
            key = prompt[b * align:(b + 1) * align].tobytes()
            if len(key) < align * 4:
                break  # ragged tail: never index a partial block
            child = node.children.get(key)
            if child is None:
                segs = [_as_tensor(s, self.device) for s in segs]
                got = [(s.dtype, tuple(s.shape)) for s in segs]
                if got != want:
                    raise ValueError(
                        f"import_prefix block {b}: segments {got} do not "
                        f"match this engine's {want}")
                child = store.insert(node, key, segs)
                installed += 1
            else:
                store._touch(child)
            node = child
        if installed:
            evicted = store.evict_to_budget()
            if evicted:
                telemetry.metrics().counter(
                    "serving_prefix_evictions_total").inc(evicted)
        return installed

    # ---- results ------------------------------------------------------

    def _finish(self, pool: _Pool, slot: int) -> dict:
        """Evict the finished request and assemble its result.  Times
        are ``telemetry.now()``: ``ttft = t_first - t_submit``,
        ``latency = t_finish - t_submit``; engine keys win over meta."""
        req = pool.reqs[slot]
        pool.reqs[slot] = None
        self._inflight.discard(req.rid)
        # unpin first, so this request's own path is evictable (but
        # freshly touched) when its donation goes over budget
        self._prefix_unpin(req)
        if (self._prefix is not None
                and req.weights_ver == self._weights_ver):
            # rows [0, t_p) still hold the prompt's K/V; a swap since
            # the prefill makes them hybrid, never donated
            self._donate_prefix(pool, slot, req)
        # pages go back AFTER donation (the extract reads them)
        self._release_pages(req, pool, slot)
        t_finish = telemetry.now()
        ttft = req.t_first - req.t_submit
        latency = t_finish - req.t_submit
        m = telemetry.metrics()
        m.counter("serving_finished_total", bucket=pool.env).inc()
        m.histogram("serving_ttft_seconds").observe(ttft)
        m.histogram("serving_latency_seconds").observe(latency)
        telemetry.instant("evict", bucket=pool.env, slot=slot,
                          request_id=req.rid)
        return {**req.meta,
                "request_id": req.rid, "prompt": req.prompt,
                "tokens": np.asarray(req.tokens, np.int32),
                "t_submit": req.t_submit, "t_first": req.t_first,
                "t_finish": t_finish, "ttft": ttft, "latency": latency}

    def _finish_error(self, req: _Request, error: str, env: int) -> dict:
        """Terminal error result: ``_finish``'s keys plus ``error``;
        ``tokens`` holds what was generated, ``ttft`` is None for a
        request that produced no token.  It has left its queue or slot."""
        self._inflight.discard(req.rid)
        self._prefix_unpin(req)
        self._release_pages(req)  # safety net: idempotent, no table
        t_finish = telemetry.now()
        telemetry.metrics().counter("serving_request_errors_total",
                                    bucket=env).inc()
        telemetry.instant("request_error", bucket=env, request_id=req.rid,
                          error=error)
        flight_recorder.record("request_error", request_id=req.rid,
                               bucket=env, error=error)
        ttft = None if req.t_first is None else req.t_first - req.t_submit
        return {**req.meta,
                "request_id": req.rid, "prompt": req.prompt,
                "tokens": np.asarray(req.tokens, np.int32),
                "error": error,
                "t_submit": req.t_submit, "t_first": req.t_first,
                "t_finish": t_finish, "ttft": ttft,
                "latency": t_finish - req.t_submit}

    def _note_inter_token(self, req: _Request, n: int) -> None:
        """Observe the inter-token gap of ``n`` freshly committed tokens
        (the time since the request's previous token spread over them)
        in ``serving_inter_token_seconds``.  A gap that spans a new
        program key is skipped, as the JAX engine skips one that spans a
        trace."""
        if n <= 0:
            return
        t_now = telemetry.now()
        traces = sum(self._traces.values())
        if req.t_last_tok is not None and traces == req.traces_seen:
            gap = (t_now - req.t_last_tok) / n
            h = telemetry.metrics().histogram("serving_inter_token_seconds")
            for _ in range(n):
                h.observe(gap)
        req.t_last_tok = t_now
        req.traces_seen = traces

    # ---- speculative decode -------------------------------------------

    def _commit_tokens(self, req: _Request, cand: list) -> tuple[int, bool]:
        """Append candidates under the per-token stop scan (``max_new``
        and ``eos_id`` apply to every token: generation stops mid-window).
        Returns ``(committed, finished)``."""
        c = 0
        fin = False
        for t in cand:
            req.tokens.append(int(t))
            c += 1
            if len(req.tokens) >= req.max_new or req.tokens[-1] == req.eos_id:
                fin = True
                break
        self._note_inter_token(req, c)
        return c, fin

    def _spec_grow(self, pool: _Pool, slot: int, req: _Request, start: int,
                   width: int) -> bool:
        """Cover rows ``[0, start + width)`` before a wide verify, without
        preemption: a shortage falls back to the single-token verify."""
        need = paging.pages_for(min(pool.env, start + width), self.page_size)
        extra = need - len(req.pages)
        if extra <= 0:
            return True
        if not self._alloc.fits_quota(extra, req.tenant):
            return False
        pids = self._alloc_pages(extra, req.tenant)
        if pids is None:
            return False
        req.pages.extend(pids)
        self._set_table_row(pool, slot, req.pages)
        return True

    def _spec_rewind(self, pool: _Pool, slot: int, req: _Request,
                     pos_next: int) -> int:
        """Return pages past the committed frontier (``pos_next + 1``
        rows stay covered, never fewer than the padded prompt's) to the
        allocator."""
        t_pad = min(pool.env, _ceil_to(len(req.prompt), self.prefill_align))
        keep = max(paging.pages_for(min(pool.env, pos_next + 1),
                                    self.page_size),
                   paging.pages_for(t_pad, self.page_size))
        if len(req.pages) <= keep:
            return 0
        drop = req.pages[keep:]
        del req.pages[keep:]
        self._alloc.free(drop, req.tenant)
        telemetry.metrics().counter("serving_pages_freed_total").inc(
            len(drop))
        self._set_table_row(pool, slot, req.pages)
        return len(drop)

    def _draft_invalidate(self, pool: _Pool, slot: int) -> None:
        """Mark one slot's draft cache stale (rebuilt from the ledger at
        the next propose)."""
        if pool.spec is not None:
            pool.spec["dpos"][slot] = -1

    @torch.no_grad()
    def _draft_propose(self, pool: _Pool, elig: dict) -> dict:
        """Draft proposals for every eligible slot: rebuild invalidated
        draft caches from their ledgers, then one batched run of
        ``k + 1`` greedy draft steps.  Returns ``{slot: k proposals}``."""
        d = pool.spec
        draft = self._spec["draft_model"]
        call = self._call(self._spec["draft_variables"], draft)
        k = self._spec["k"]
        for s, ok in sorted(elig.items()):
            if not ok or d["dpos"][s] >= 0:
                continue
            req = pool.reqs[s]
            ledger = req.ledger(pool.env)
            if len(ledger) >= 2:
                t_pad = min(pool.env, _ceil_to(len(ledger) - 1,
                                               self.prefill_align))
                padded = np.full((1, t_pad), self.pad_id, np.int32)
                padded[0, :len(ledger) - 1] = ledger[:-1]
                self._program("draft_prefill", pool.env, t_pad)
                with telemetry.span("draft_prefill", bucket=pool.env,
                                    slot=s, padded=t_pad,
                                    request_id=req.rid):
                    _speculative.draft_prefill(
                        call, d["cache"].rows(s, s + 1),
                        torch.as_tensor(padded, dtype=torch.long,
                                        device=self.device))
            d["dpos"][s] = len(ledger) - 1
            d["dtok"][s] = ledger[-1]
        live = np.array([bool(elig.get(s)) and d["dpos"][s] >= 0
                         for s in range(pool.n_slots)])
        if not live.any():
            return {}
        self._program("draft_step", pool.env)
        with telemetry.span("draft_step", bucket=pool.env, k=k):
            dev = self.device
            props = _speculative.draft_propose(
                call, d["cache"],
                torch.as_tensor(d["dtok"], dtype=torch.long, device=dev),
                torch.as_tensor(d["dpos"], dtype=torch.long, device=dev),
                torch.as_tensor(live, device=dev),
                env=pool.env, k=k, pad_id=self.pad_id).cpu().numpy()
        return {s: props[:, s] for s in range(pool.n_slots) if live[s]}

    def _spec_decode(self, pool: _Pool, variables) -> list[dict]:
        """One speculative quantum for a pool, in place of the batched
        step: per live slot, propose up to ``k`` tokens, verify the
        window in one dense pass, commit the accepted prefix and the
        bonus token under the per-token stop scan, roll the rejected
        tail back (position rewind; paged, tail pages too).  A slot with
        no proposal (or short of budget or pages, or opted out) runs the
        single-token verify."""
        spec = self._spec
        k = spec["k"]
        m = telemetry.metrics()
        finished: list[dict] = []
        slots = [s for s, r in enumerate(pool.reqs)
                 if r is not None and s not in pool.prefilling]
        if not slots:
            return finished
        # the whole k+1 window must fit the remaining budget, which with
        # routing's t_p + max_new <= env bounds every written row to
        # env - 2
        elig = {s: (pool.reqs[s].spec_on is not False
                    and pool.reqs[s].max_new
                    - len(pool.reqs[s].tokens) > k)
                for s in slots}
        props: dict = {}
        if spec["draft_model"] is not None and any(elig.values()):
            props = self._draft_propose(pool, elig)
        n_tok = 0
        for s in slots:
            req = pool.reqs[s]
            ledger = req.ledger(pool.env)
            start = len(ledger) - 1
            p = np.empty((0,), np.int32)
            if elig[s]:
                if spec["draft_model"] is None:
                    p = _speculative.ngram_propose(ledger, k, spec["ngram"])
                else:
                    p = props.get(s, p)
            width = k + 1 if len(p) else 1
            if (width > 1 and self._paged
                    and not self._spec_grow(pool, s, req, start, width)):
                p = p[:0]  # page-short: the 1-wide verify
                width = 1
            chunk = np.full((1, width), self.pad_id, np.int32)
            chunk[0, 0] = ledger[-1]
            chunk[0, 1:1 + len(p)] = p
            try:
                with telemetry.span("verify", bucket=pool.env, slot=s,
                                    width=width, request_id=req.rid):
                    greedy = self._run_verify(pool, s, chunk, start,
                                              variables)
            except Exception as e:
                pool.reqs[s] = None
                self._release_pages(req, pool, s)
                finished.append(self._finish_error(
                    req, f"verify_failed: {e!r}", pool.env))
                continue
            n = _speculative.accept_length(p, greedy)
            c, fin = self._commit_tokens(
                req, [int(x) for x in p[:n]] + [int(greedy[n])])
            n_tok += c
            if len(p):
                self._spec_proposed += len(p)
                self._spec_accepted += n
                m.counter("serving_spec_proposed_total",
                          bucket=pool.env).inc(len(p))
                m.counter("serving_spec_accepted_total",
                          bucket=pool.env).inc(n)
                m.histogram("serving_spec_accept_len").observe(n)
                m.gauge("serving_spec_accept_rate").set(
                    self._spec_accepted / max(self._spec_proposed, 1))
                rejected = len(p) - n
                if rejected:
                    freed = (0 if fin or not self._paged
                             else self._spec_rewind(pool, s, req, start + c))
                    flight_recorder.record(
                        "spec_rollback", request_id=req.rid,
                        bucket=pool.env, rejected=rejected,
                        pages_freed=freed)
            if spec["draft_model"] is not None and not fin:
                # the k+1-step propose wrote every accepted row's draft
                # K/V: only the host mirrors move
                pool.spec["dpos"][s] = start + c
                pool.spec["dtok"][s] = req.tokens[-1]
            if fin:
                finished.append(self._finish(pool, s))
        if n_tok:
            m.counter("serving_tokens_total", bucket=pool.env).inc(n_tok)
        return finished

    def spec_stats(self) -> dict:
        """Host-side speculative-decoding counters."""
        if self._spec is None:
            return {"enabled": False}
        p, a = self._spec_proposed, self._spec_accepted
        return {"enabled": True, "proposer": self._spec["proposer"],
                "k": self._spec["k"], "proposed": p, "accepted": a,
                "accept_rate": (a / p) if p else None}

    # ---- serving loop -------------------------------------------------

    def has_work(self) -> bool:
        return (any(p.live() or p.queue for p in self._pools)
                or bool(self._parked))

    def load(self) -> dict:
        """Queued, live and preempted-parked request counts."""
        with self._lock:
            return {"queued": sum(len(p.queue) for p in self._pools),
                    "live": sum(1 for p in self._pools
                                for r in p.reqs if r is not None),
                    "parked": len(self._parked)}

    def step(self) -> list[dict]:
        """Admit waiting requests into free slots, advance every live
        bucket (one pending prefill chunk, then ``steps_per_sync``
        tokens or one speculative quantum), evict finished requests and
        return their results (as completed).  Deadline-expired requests
        come back as ``error`` results."""
        if self._closed:
            raise RuntimeError("engine is closed; step after close()")
        finished = self._admit()
        m = telemetry.metrics()
        # one weights snapshot per step (see _admit)
        variables = self.variables
        for pool in self._pools:
            # at most ONE chunk per pool per step: a live slot's gap is
            # one chunk program, never the whole prompt
            if pool.prefilling:
                slot = next(iter(pool.prefilling))
                finished.extend(self._advance_prefill(pool, slot,
                                                      variables))
            if self._paged:
                # every live slot's pages must cover this quantum's writes
                finished.extend(self._grow_pages(pool))
            if not pool.decodable():
                continue
            if self._spec is not None:
                finished.extend(self._spec_decode(pool, variables))
            else:
                # the span covers the steps and the host sync
                with telemetry.span("decode_step", bucket=pool.env,
                                    steps=self.steps_per_sync):
                    toks, was_done = self._run_step(pool, variables)
                n_tok = 0
                for slot, req in enumerate(pool.reqs):
                    if req is None or slot in pool.prefilling:
                        continue
                    got = 0
                    fin = False
                    for k in range(toks.shape[0]):
                        if was_done[k, slot]:
                            break
                        req.tokens.append(int(toks[k, slot]))
                        got += 1
                        if (len(req.tokens) >= req.max_new
                                or req.tokens[-1] == req.eos_id):
                            fin = True
                            break
                    if got:
                        self._note_inter_token(req, got)
                        n_tok += got
                    if fin:
                        finished.append(self._finish(pool, slot))
                if n_tok:
                    m.counter("serving_tokens_total",
                              bucket=pool.env).inc(n_tok)
            # live requests past their deadline free the slot now
            now = telemetry.now()
            for slot, req in enumerate(pool.reqs):
                if (req is not None and req.deadline is not None
                        and now > req.deadline):
                    pool.reqs[slot] = None
                    pool.prefilling.pop(slot, None)
                    self._release_pages(req, pool, slot)
                    pool.state["done"][slot] = True
                    m.counter("serving_shed_total", reason="deadline",
                              bucket=pool.env).inc()
                    telemetry.instant("evict", bucket=pool.env, slot=slot,
                                      request_id=req.rid)
                    finished.append(self._finish_error(
                        req, "deadline_exceeded", pool.env))
            self._note_gauges(pool)
        finished.extend(self._admit())
        return finished

    def drain(self) -> list[dict]:
        """Serve everything in flight to completion; returns all results
        (as completed), queued requests included."""
        out = []
        while self.has_work():
            out.extend(self.step())
        return out

    def close(self) -> list[dict]:
        """Cancel queued, live and parked requests (``error=
        "engine_closed"`` results, every in-flight id accounted for),
        release the device pools, the pages and the prefix store; later
        ``submit``/``step`` calls raise."""
        with self._lock:
            if self._closed:
                return []
            out = []
            for pool in self._pools:
                while pool.queue:
                    out.append(self._finish_error(pool.queue.popleft(),
                                                  "engine_closed",
                                                  pool.env))
                for slot, req in enumerate(pool.reqs):
                    if req is not None:
                        pool.reqs[slot] = None
                        out.append(self._finish_error(req, "engine_closed",
                                                      pool.env))
                pool.prefilling.clear()
                pool.cache = pool.state = None  # release the pool
                pool.spec = None
                pool.table = pool.table_np = None
                self._note_gauges(pool)
            for req in self._parked:
                env = req.swap["pool"].env if req.swap else 0
                out.append(self._finish_error(req, "engine_closed", env))
            self._parked.clear()
            self._pages = None  # release the page pool
            if self._prefix is not None:
                self._prefix.clear()
            self._closed = True
        flight_recorder.record("engine_closed", cancelled=len(out))
        flight_recorder.flush()
        return out

    def health(self) -> dict:
        """SLO verdict over the active metrics registry."""
        return telemetry.metrics().health()

    def __enter__(self) -> "DecodeEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _submit_item(self, item):
        """``run``'s item contract: a prompt array, or a mapping with
        ``"prompt"`` (+ optional ``"max_new_tokens"``, ``"eos_id"``,
        ``"tenant"``, ``"priority"``, ``"speculative"``; other keys ride
        into the result as meta)."""
        if isinstance(item, Mapping):
            meta = {k: v for k, v in item.items()
                    if k not in ("prompt", "max_new_tokens", "eos_id",
                                 "tenant", "priority", "speculative")}
            return self.submit(item["prompt"],
                               max_new_tokens=item.get("max_new_tokens"),
                               eos_id=item.get("eos_id", _UNSET),
                               tenant=item.get("tenant"),
                               priority=item.get("priority", 1),
                               speculative=item.get("speculative"),
                               meta=meta)
        return self.submit(item)

    def run(self, requests: Iterable, *, ordered: bool = True
            ) -> Iterator[dict]:
        """Serve an iterable of requests to completion, one result per
        item: in submission order (``ordered=True``) or as completed.
        With ``queue_bound`` set, a shed is backpressure: submission
        pauses while the engine steps, then resumes."""
        order: list = []
        buffered: dict = {}
        next_emit = 0
        stalled = None  # item shed at the door, awaiting capacity
        it = iter(requests)
        exhausted = False
        while True:
            while not exhausted or stalled is not None:
                if stalled is None:
                    try:
                        stalled = next(it)
                    except StopIteration:
                        exhausted = True
                        break
                try:
                    order.append(self._submit_item(stalled))
                    stalled = None
                except ShedError:
                    break
            if not self.has_work():
                if exhausted and stalled is None:
                    break
                raise RuntimeError(
                    "run(): request shed while the engine is idle — "
                    "the engine is being stepped/drained concurrently")
            for res in self.step():
                if not ordered:
                    yield res
                    continue
                buffered[res["request_id"]] = res
                while (next_emit < len(order)
                       and order[next_emit] in buffered):
                    yield buffered.pop(order[next_emit])
                    next_emit += 1
        if ordered:
            while next_emit < len(order):
                yield buffered.pop(order[next_emit])
                next_emit += 1

    @property
    def compile_counts(self) -> dict:
        """``{(kind, bucket[, padded]): 1}``, one entry per program key
        the engine has run, the JAX engine's trace keys: steady-state
        serving adds none, nor does a weight swap."""
        return dict(self._traces)
