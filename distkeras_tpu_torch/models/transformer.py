"""Decoder-only Transformer LM, the port of
``distkeras_tpu/models/transformer.py`` (dense, flash and blockwise
attention, a custom ``attn_fn``, sequence parallelism over a ring
(``seq_axis``), GQA, the decode-mode KV cache and its int8 form, slot
mode, ``cache_envelope``).

Parameters are held in the compute dtype except the LayerNorm affines
and ``lm_head``, which stay f32: flax casts its f32 parameters to the
module dtype at every use, so casting once at load gives the same
values.  Training keeps f32 master parameters apart
(``workers.TrainState``) and casts them to these dtypes at each forward,
as flax does.  ``init_params`` draws them as flax's initializers do.

Decode mode keeps its KV cache as explicit tensors (``KVCache``)
passed in and returned by ``forward``: per layer ``[B, KVH, L, D]``
keys and values plus one scalar insertion index.  ``forward`` writes
the cache IN PLACE, so a caller that passes views of a larger pool
(``serving.DecodeEngine`` passes one slot's rows) updates that pool
without a copy.  ``kv_cache_dtype="int8"`` stores the cache quantized
per position and head (``_quantize_kv``, with ``[B, KVH, L, 1]`` f32
scales); a prefill through the kernel attends on the raw projections,
the dense read factors the scales out of both contractions.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from distkeras_tpu_torch.models.core import register_model
from distkeras_tpu_torch.ops.attention import flash_attn_fn
from distkeras_tpu_torch.parallel import ring_attention as _ring

_ATTN_CHOICES = ("auto", "dense", "blockwise", "flash")
_NEG = -1e30
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _unsupported(key: str, item: str):
    return NotImplementedError(
        f"{key} is not ported to distkeras_tpu_torch yet ({item} in "
        "ROADMAP.md)")


# flax's truncated normal is cut at two standard deviations; this is the
# std of the unit normal so cut, by which flax divides to keep the
# requested std (jax.nn.initializers.variance_scaling)
_TRUNC_STD = 0.87962566103423978


def _lecun_normal(shape, generator) -> torch.Tensor:
    """flax ``lecun_normal`` for a torch ``[out, in]`` weight: truncated
    normal of std ``in ** -0.5``."""
    std = shape[1] ** -0.5 / _TRUNC_STD
    w = torch.empty(shape)
    return nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                 generator=generator)


def dense_causal_attention(q, k, v, *, scale):
    """Plain causal attention: ``[B, T, H, D] -> [B, T, H, D]``."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    t = q.shape[1]
    keep = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
    logits = logits.masked_fill(~keep, _NEG)
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _quantize_kv(x):
    """Symmetric int8 quantization of a K/V chunk per row of its last
    axis (batch, position, head): ``(int8 values, f32 scales [..., 1])``
    with scale ``amax / 127`` and round half to even, as
    ``jnp.round``."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1, keepdim=True) / 127.0
    q = torch.where(scale > 0.0, xf / scale.clamp_min(1e-30),
                    torch.zeros_like(xf))
    return torch.round(q).clamp(-127, 127).to(torch.int8), scale


def flax_layer_order(n: int) -> list:
    """Layer indices in the flax cache tree's flatten order: its
    ``Block_{i}`` keys sort as strings (``Block_10`` before
    ``Block_2``)."""
    return sorted(range(n), key=lambda i: f"Block_{i}")


class KVCache:
    """Decode-mode cache: ``keys[i]``/``values[i]`` are layer ``i``'s
    ``[B, KVH, L, D]`` tensors; ``index`` is the scalar insertion
    position of the scalar-index contract (slot mode leaves it be:
    each row's position comes with the call).  An int8 cache also holds
    ``key_scales[i]``/``value_scales[i]``, ``[B, KVH, L, 1]`` f32."""

    def __init__(self, keys: list, values: list, index: int = 0,
                 key_scales: Optional[list] = None,
                 value_scales: Optional[list] = None):
        self.keys = keys
        self.values = values
        self.index = int(index)
        self.key_scales = key_scales
        self.value_scales = value_scales

    @property
    def length(self) -> int:
        return self.keys[0].shape[2]

    @property
    def quantized(self) -> bool:
        return self.key_scales is not None

    def leaves(self) -> list:
        """The 4-D tensors in the flax cache tree's flatten order: per
        layer (``flax_layer_order``) ``cached_key``, ``cached_value``
        and, int8, ``key_scale``, ``value_scale``."""
        out = []
        for i in flax_layer_order(len(self.keys)):
            out += [self.keys[i], self.values[i]]
            if self.quantized:
                out += [self.key_scales[i], self.value_scales[i]]
        return out

    @classmethod
    def from_leaves(cls, leaves: list, quantized: bool,
                    index: int = 0) -> "KVCache":
        """Inverse of ``leaves``."""
        per = 4 if quantized else 2
        n = len(leaves) // per
        slots: list = [[None] * n for _ in range(per)]
        for j, i in enumerate(flax_layer_order(n)):
            for f in range(per):
                slots[f][i] = leaves[j * per + f]
        return cls(slots[0], slots[1], index,
                   *(slots[2:] if quantized else ()))

    def rows(self, lo: int, hi: int) -> "KVCache":
        """Views of batch rows ``lo:hi``: writes land in this cache."""
        return KVCache.from_leaves([t[lo:hi] for t in self.leaves()],
                                   self.quantized, self.index)


class LayerNorm(nn.Module):
    """flax ``LayerNorm``: f32 statistics (mean and ``E[x^2]-E[x]^2``
    clipped at 0), eps 1e-6, f32 affine, output in the input dtype."""

    def __init__(self, d: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = ((xf * xf).mean(-1, keepdim=True) - mean * mean
               ).clamp_min(0.0)
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.scale)
        return (y + self.bias).to(x.dtype)


def _dense(x, layer: nn.Linear):
    # flax Dense: the product and the bias add round separately
    return F.linear(x, layer.weight) + layer.bias


class SelfAttention(nn.Module):
    def __init__(self, d_model: int, num_heads: int,
                 num_kv_heads: Optional[int], dtype: torch.dtype):
        super().__init__()
        if d_model % num_heads:
            raise ValueError(
                f"d_model={d_model} not divisible by "
                f"num_heads={num_heads}")
        kvh = num_kv_heads or num_heads
        if num_heads % kvh:
            raise ValueError(
                f"num_heads={num_heads} not divisible by "
                f"num_kv_heads={kvh}")
        self.num_heads, self.kvh = num_heads, kvh
        self.head_dim = d_model // num_heads
        self.group = num_heads // kvh
        hd = self.head_dim
        self.query = nn.Linear(d_model, num_heads * hd, dtype=dtype)
        self.key = nn.Linear(d_model, kvh * hd, dtype=dtype)
        self.value = nn.Linear(d_model, kvh * hd, dtype=dtype)
        self.out = nn.Linear(num_heads * hd, d_model, dtype=dtype)

    def forward(self, x, attn_fn, cache: Optional[KVCache] = None,
                layer: int = 0, slot_pos=None):
        b, t, _ = x.shape
        hd, kvh, group = self.head_dim, self.kvh, self.group
        q = _dense(x, self.query).view(b, t, self.num_heads, hd)
        k = _dense(x, self.key).view(b, t, kvh, hd)
        v = _dense(x, self.value).view(b, t, kvh, hd)
        scale = hd ** -0.5
        if cache is None:
            attn = attn_fn or dense_causal_attention
            if group > 1:
                # attention fns take matched head counts
                k = k.repeat_interleave(group, dim=2)
                v = v.repeat_interleave(group, dim=2)
            out = attn(q, k, v, scale=scale)
        else:
            out = self._decode(q, k, v, attn_fn, cache, layer, slot_pos,
                               scale)
        return _dense(out.reshape(b, t, self.num_heads * hd), self.out)

    def _decode(self, q, k, v, attn_fn, cache, layer, slot_pos, scale):
        b, t = q.shape[:2]
        hd, kvh, group = self.head_dim, self.kvh, self.group
        keys, vals = cache.keys[layer], cache.values[layer]
        writes = [(keys, k), (vals, v)]
        if cache.quantized:
            k_w, k_s = _quantize_kv(k)
            v_w, v_s = _quantize_kv(v)
            ks, vs = cache.key_scales[layer], cache.value_scales[layer]
            writes = [(keys, k_w), (vals, v_w), (ks, k_s), (vs, v_s)]
        length = keys.shape[2]
        idx = cache.index
        if slot_pos is not None:
            if t != 1:
                raise ValueError(
                    "slot_pos is the continuous-batching T=1 step "
                    f"contract; got a T={t} chunk")
            # per-row write at each row's own position; an out-of-range
            # row keeps its cache and is poisoned below
            ok = slot_pos < length                             # [B]
            pos = slot_pos.clamp(max=length - 1)
            rows = torch.arange(b, device=q.device)
            for cache_t, new in writes:
                old = cache_t[rows, :, pos]                     # [B,KVH,D]
                cache_t[rows, :, pos] = torch.where(
                    ok[:, None, None], new[:, 0], old)
        else:
            # an overflowing write lands clamped (as a dynamic update
            # slice does) and the output is poisoned below
            start = min(idx, length - t)
            for cache_t, new in writes:
                cache_t[:, :, start:start + t] = new.transpose(1, 2)
            ok = idx + t <= length
        if t > 1 and attn_fn is not None:
            # prefill through the kernel: causal attention within the
            # chunk on the raw (unquantized) projections, exact iff the
            # cache was empty
            kf, vf = k, v
            if group > 1:
                kf = kf.repeat_interleave(group, dim=2)
                vf = vf.repeat_interleave(group, dim=2)
            out = attn_fn(q, kf, vf, scale=scale)
            ok = ok and idx == 0
        else:
            if slot_pos is not None:
                q_pos = slot_pos[:, None]                       # [B, 1]
            else:
                q_pos = (idx + torch.arange(t, device=q.device))[None]
            k_pos = torch.arange(length, device=q.device)
            mask = k_pos[None, None, :] <= q_pos[:, :, None]    # [B|1,t,L]
            if cache.quantized:
                # the per-row scales factor out of both contractions;
                # the cast to the compute dtype copies the cache
                keys, vals = keys.to(q.dtype), vals.to(q.dtype)
            qg = q.reshape(b, t, kvh, group, hd)
            logits = torch.einsum("bqhgd,bhkd->bhgqk", qg, keys) * scale
            if cache.quantized:
                logits = logits * ks[:, :, None, None, :, 0]
            logits = logits.masked_fill(~mask[:, None, None], _NEG)
            probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
            if cache.quantized:
                probs = (probs.float() * vs[:, :, None, None, :, 0]
                         ).to(q.dtype)
            out = torch.einsum("bhgqk,bhkd->bqhgd", probs, vals)
            out = out.reshape(b, t, self.num_heads, hd)
        if isinstance(ok, torch.Tensor):
            return out.masked_fill(~ok[:, None, None, None], float("nan"))
        return out if ok else torch.full_like(out, float("nan"))


class Block(nn.Module):
    def __init__(self, d_model: int, num_heads: int, mlp_ratio: int,
                 num_kv_heads: Optional[int], dtype: torch.dtype):
        super().__init__()
        self.ln1 = LayerNorm(d_model)
        self.attn = SelfAttention(d_model, num_heads, num_kv_heads, dtype)
        self.ln2 = LayerNorm(d_model)
        self.mlp_in = nn.Linear(d_model, d_model * mlp_ratio, dtype=dtype)
        self.mlp_out = nn.Linear(d_model * mlp_ratio, d_model, dtype=dtype)

    def forward(self, x, attn_fn, cache=None, layer=0, slot_pos=None):
        x = x + self.attn(self.ln1(x), attn_fn, cache, layer, slot_pos)
        y = F.gelu(_dense(self.ln2(x), self.mlp_in), approximate="tanh")
        return x + _dense(y, self.mlp_out)


@register_model("transformer_lm")
class TransformerLM(nn.Module):
    """The JAX package's ``TransformerLM`` with the same config keys.

    ``forward(tokens)`` is the training-mode forward (``[B, T, V]``
    f32 logits); ``train`` and ``rng`` (flax's mode and dropout stream,
    which the train step passes every model) change nothing: the LM has
    no dropout.  Decode mode (``decode=True`` or a ``cache`` passed)
    returns ``(logits, cache)``: logits of the last position, or of
    ``last_index``, or of every position with ``logits_all``; the cache
    is written in place.  A multi-token chunk at a 128-aligned length
    runs the resolved attention kernel; other chunks and every T=1
    step read the cache densely.

    ``attn``: ``"auto"`` picks flash wherever the JAX recipe picks a
    blocked spelling (T >= 1024, T % 128 == 0) and dense below;
    ``"flash"``/``flash_attn=True``, ``"blockwise"``/``blockwise_attn=
    True`` (q chunks of ``attn_q_chunk``, default 128) and ``"dense"``
    force one; ``attn_fn`` overrides them all.

    ``seq_axis`` names a ring (``parallel.ring_attention``): the forward
    must run under ``sequence_sharded_apply(fn, ring, seq_axis)``.  Its
    tokens are the ring's blocks held by this process (one rank's block
    under a ``ProcessGroupRing``, the whole sequence under an
    ``InProcessRing``); positions are global, and attention defaults to
    ``ring_attn_fn(seq_axis, q_chunk=attn_q_chunk)``.  The parameters
    are the dense model's."""

    def __init__(self, vocab_size: int = 32000, num_layers: int = 4,
                 d_model: int = 256, num_heads: int = 4,
                 mlp_ratio: int = 4, max_len: int = 2048,
                 dtype: str = "bfloat16", attn_fn=None, seq_axis=None,
                 attn_q_chunk=None, attn: str = "auto",
                 blockwise_attn: bool = False, flash_attn: bool = False,
                 num_kv_heads: Optional[int] = None,
                 kv_cache_dtype: Optional[str] = None,
                 num_experts: int = 0,
                 expert_capacity_factor: float = 1.25,
                 expert_top_k: int = 1, scan_blocks: bool = False,
                 remat_blocks: bool = False, decode: bool = False,
                 cache_envelope: Optional[int] = None):
        super().__init__()
        if num_experts > 0:
            raise _unsupported("num_experts>0", "queue 1, parallelism")
        if kv_cache_dtype not in (None, "int8"):
            raise ValueError(
                f"kv_cache_dtype={kv_cache_dtype!r} must be None "
                "(activation dtype) or 'int8'")
        if scan_blocks:
            raise _unsupported("scan_blocks", "queue 1, LM training")
        if remat_blocks:
            raise _unsupported("remat_blocks", "queue 1, LM training")
        if attn not in _ATTN_CHOICES:
            raise ValueError(f"attn={attn!r} not one of {_ATTN_CHOICES}")
        if blockwise_attn and flash_attn:
            raise ValueError(
                "blockwise_attn and flash_attn are mutually exclusive "
                "spellings of the device-local flash-style attention path")
        if seq_axis is not None and (blockwise_attn or flash_attn
                                     or attn != "auto"):
            raise ValueError(
                "blockwise_attn/flash_attn/attn are device-local "
                "attention spellings; with seq_axis the attention is "
                "ring attention over the ring: use attn_q_chunk to bound "
                "its within-block chunks instead")
        if decode and seq_axis is not None:
            raise ValueError(
                "decode=True is the KV-cache serving path: seq_axis does "
                "not apply (generate() serves a seq_axis model without it)")
        if dtype not in _DTYPES:
            raise ValueError(f"dtype={dtype!r} not one of {list(_DTYPES)}")
        if cache_envelope is not None and not decode:
            raise ValueError(
                "cache_envelope sizes the decode-mode KV cache; it has "
                "no meaning without decode=True")
        if cache_envelope is not None and not 0 < cache_envelope <= max_len:
            raise ValueError(
                f"cache_envelope={cache_envelope} outside (0, "
                f"max_len={max_len}]")
        self.vocab_size, self.num_layers = vocab_size, num_layers
        self.d_model, self.num_heads = d_model, num_heads
        self.max_len = max_len
        self.compute_dtype = _DTYPES[dtype]
        self.attn, self.flash_attn = attn, flash_attn
        self.blockwise_attn, self.attn_fn = blockwise_attn, attn_fn
        self.seq_axis, self.attn_q_chunk = seq_axis, attn_q_chunk
        self.num_kv_heads = num_kv_heads
        self.kv_cache_dtype = kv_cache_dtype
        self.decode, self.cache_envelope = decode, cache_envelope
        cd = self.compute_dtype
        # built on the meta device, so torch's own initializers draw
        # nothing: the one draw is init_params', cast to each tensor's dtype
        with torch.device("meta"):
            self.embed = nn.Embedding(vocab_size, d_model, dtype=cd)
            self.pos_embed = nn.Embedding(max_len, d_model, dtype=cd)
            self.blocks = nn.ModuleList(
                Block(d_model, num_heads, mlp_ratio, num_kv_heads, cd)
                for _ in range(num_layers))
            self.ln_f = LayerNorm(d_model)
            self.lm_head = nn.Linear(d_model, vocab_size,
                                     dtype=torch.float32)
        own = self.state_dict()
        self.load_state_dict({n: v.to(own[n].dtype)
                              for n, v in self.init_params().items()},
                             assign=True)

    def init_params(self, generator: Optional[torch.Generator] = None
                    ) -> dict:
        """f32 parameters on the CPU, drawn as the JAX package's flax
        initializers draw them: ``nn.Embed`` tables N(0, 1/d); Dense
        kernels ``lecun_normal`` (std ``fan_in ** -0.5``, truncated at
        two standard deviations); biases 0; LayerNorm scale 1 and bias
        0.  Keys and shapes are the ``state_dict``'s.  The draws come
        from ``generator`` (default: torch's global one), so they differ
        from the JAX package's: carry weights across with ``convert``."""
        out = {}
        for prefix, mod in self.named_modules():
            pre = f"{prefix}." if prefix else ""
            if isinstance(mod, nn.Embedding):
                out[pre + "weight"] = torch.empty(mod.weight.shape).normal_(
                    0.0, mod.embedding_dim ** -0.5, generator=generator)
            elif isinstance(mod, nn.Linear):
                out[pre + "weight"] = _lecun_normal(mod.weight.shape,
                                                    generator)
                out[pre + "bias"] = torch.zeros(mod.out_features)
            elif isinstance(mod, LayerNorm):
                out[pre + "scale"] = torch.ones(mod.scale.shape)
                out[pre + "bias"] = torch.zeros(mod.bias.shape)
        return out

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads

    def new_cache(self, batch: int, length: Optional[int] = None,
                  device=None) -> KVCache:
        """An empty decode cache of ``length`` positions (default:
        ``cache_envelope`` or ``max_len``)."""
        length = length or self.cache_envelope or self.max_len
        if not 0 < length <= self.max_len:
            raise ValueError(
                f"cache length {length} outside (0, max_len="
                f"{self.max_len}]")
        dev = device or self.embed.weight.device
        shape = (batch, self.kv_heads, length, self.head_dim)
        store = (torch.int8 if self.kv_cache_dtype == "int8"
                 else self.compute_dtype)

        def zeros(dtype=store, d=self.head_dim):
            return torch.zeros(shape[:3] + (d,), dtype=dtype, device=dev)

        n = len(self.blocks)
        if self.kv_cache_dtype != "int8":
            return KVCache([zeros() for _ in range(n)],
                           [zeros() for _ in range(n)])
        return KVCache([zeros() for _ in range(n)],
                       [zeros() for _ in range(n)], 0,
                       [zeros(torch.float32, 1) for _ in range(n)],
                       [zeros(torch.float32, 1) for _ in range(n)])

    def _local_attn_fn(self, t: int):
        """The device-local attention for length ``t`` (None: dense).
        Precedence: ``attn_fn`` > the boolean spellings > ``attn``."""
        if self.attn_fn is not None:
            return self.attn_fn
        spelling = self.attn
        if self.flash_attn:
            spelling = "flash"
        elif self.blockwise_attn:
            spelling = "blockwise"
        if spelling == "auto":
            spelling = "dense" if t < 1024 or t % 128 else "flash"
        if spelling == "flash":
            return flash_attn_fn()
        if spelling == "blockwise":
            return _ring.blockwise_attn_fn(q_chunk=self.attn_q_chunk or 128)
        return None

    def _ring_positions(self, t: int, dev):
        """Global positions of this process's ``t`` tokens on the ring
        ``seq_axis`` names, and the ring's whole length."""
        ring = _ring.resolve_ring(self.seq_axis)
        held = len(ring.ranks)
        if t % held:
            raise ValueError(f"sequence length {t} does not split into the "
                             f"{held} ranks held here")
        block = t // held
        positions = ring.ranks[0] * block + torch.arange(t, device=dev)
        return positions[None], block * ring.size

    def forward(self, tokens, train: bool = False, rng=None, *,
                cache: Optional[KVCache] = None,
                slot_pos=None, last_index: Optional[int] = None,
                logits_all: bool = False):
        tokens = tokens.long()
        b, t = tokens.shape
        decode = self.decode or cache is not None
        dev = tokens.device
        if (slot_pos is not None or last_index is not None
                or logits_all) and not decode:
            raise ValueError(
                "slot_pos/last_index/logits_all are decode-mode "
                "serving contracts; set decode=True or pass a cache")
        if logits_all and last_index is not None:
            raise ValueError("pass at most one of logits_all/last_index")
        if t > self.max_len:
            raise ValueError(
                f"sequence length {t} exceeds max_len={self.max_len}")
        if decode and self.seq_axis is not None:
            raise ValueError(
                "decode is the KV-cache serving path: seq_axis does not "
                "apply (generate() serves a seq_axis model without it)")
        if decode:
            if cache is None:
                cache = self.new_cache(b)
            if t > cache.length:
                raise ValueError(
                    f"decode chunk length {t} exceeds the cache size "
                    f"{cache.length}")
            if slot_pos is not None and t != 1:
                raise ValueError(
                    "slot_pos advances every live slot by ONE token; "
                    f"got a T={t} chunk")
            if slot_pos is not None:
                positions = slot_pos.long()[:, None]
            else:
                positions = (cache.index
                             + torch.arange(t, device=dev))[None]
            # out-of-table positions clamp as a gather does; their
            # outputs are NaN-poisoned by the cache overflow check
            positions = positions.clamp(max=self.max_len - 1)
            # a custom attn_fn is honored as given (its caller owns its
            # shape contract; generate() clears it)
            attn_fn = (self._local_attn_fn(t) if t > 1 and (
                self.attn_fn is not None or t % 128 == 0) else None)
        elif self.seq_axis is not None:
            positions, t_global = self._ring_positions(t, dev)
            if t_global > self.max_len:
                raise ValueError(f"ring sequence length {t_global} exceeds "
                                 f"max_len={self.max_len}")
            attn_fn = self.attn_fn
            if attn_fn is None:
                attn_fn = _ring.ring_attn_fn(self.seq_axis,
                                             q_chunk=self.attn_q_chunk)
        else:
            positions = torch.arange(t, device=dev)[None]
            attn_fn = self._local_attn_fn(t)
        x = self.embed(tokens) + self.pos_embed(positions)
        for i, block in enumerate(self.blocks):
            x = block(x, attn_fn, cache if decode else None, i, slot_pos)
        if decode:
            if slot_pos is None:
                cache.index += t
            if last_index is not None:
                li = min(max(int(last_index), 0), t - 1)
                x = x[:, li:li + 1]
            elif not logits_all:
                x = x[:, -1:]
        logits = F.linear(self.ln_f(x).float(), self.lm_head.weight) \
            + self.lm_head.bias
        return (logits, cache) if decode else logits
