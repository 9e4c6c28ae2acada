"""Autoregressive generation for ``TransformerLM``, the port of
``distkeras_tpu/models/generate.py`` (``beam_search`` is not ported
yet).

The prompt runs through one decode-mode forward that fills every
layer's KV cache, then each new token is one cached T=1 step.  Greedy
(``temperature=0``), temperature, top-k and top-p sampling; sampling
draws from an explicit ``torch.Generator``.

The prompt is right-padded to a multiple of ``PREFILL_ALIGN`` for the
prefill, exactly as ``serving.DecodeEngine`` pads it, and the logits
of the true last token seed generation.  Causal attention keeps the
real rows independent of the pad rows, and the pad rows' K/V sit past
every decode step's horizon until that step overwrites them, so the
result is the unpadded one; what the padding buys is that the
prefill's attention takes the model's kernel (which wants 128-aligned
chunks) and runs on the same shape as the engine's prefill.
"""

from __future__ import annotations

import copy
from typing import Mapping, Optional

import torch

from distkeras_tpu_torch.models.core import ModelSpec
from distkeras_tpu_torch.models.transformer import KVCache, TransformerLM

PREFILL_ALIGN = 128


def _ceil_to(n: int, align: int) -> int:
    return -(-n // align) * align


def _decode_model(model, device=None) -> TransformerLM:
    """A ``TransformerLM`` ready to serve: built from a config dict or
    ``ModelSpec`` on ``device`` (default ``cuda``), or taken as given.
    A custom ``attn_fn`` and the ring (``seq_axis``) are cleared, as the
    JAX package's ``generate`` clears them (their contracts are the
    training path's shapes): a shallow copy shares the weights."""
    if isinstance(model, Mapping):
        model = ModelSpec.from_config(model).build(device=device)
    elif isinstance(model, ModelSpec):
        model = model.build(device=device)
    if not isinstance(model, TransformerLM):
        raise TypeError(
            "generate() serves TransformerLM models; got "
            f"{type(model).__name__}")
    if model.attn_fn is not None or model.seq_axis is not None:
        model = copy.copy(model)
        model.attn_fn = model.seq_axis = None
    return model


def _filter(logits, temperature: float, top_k: Optional[int],
            top_p: Optional[float]):
    """Temperature-scaled ``[B, V]`` f32 logits with the top-k and
    top-p filters applied (filtered tokens at ``-inf``).

    Every token whose logit equals the nucleus-threshold logit is kept,
    so exact ties can admit slightly more than ``top_p`` mass."""
    logits = logits / temperature
    if top_k is not None:
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if top_p is not None:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # keep tokens whose PRECEDING cumulative mass is below top_p
        cut = ((cum - probs) < top_p).sum(dim=-1, keepdim=True)
        kth = torch.gather(sorted_logits, -1, cut - 1)
        logits = logits.masked_fill(logits < kth, float("-inf"))
    return logits


def _select(logits, temperature: float, top_k: Optional[int],
            top_p: Optional[float], generator=None):
    """Next token ``[B]`` int64 from ``[B, V]`` f32 logits."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(_filter(logits, temperature, top_k, top_p),
                          dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def prefill(dec: TransformerLM, prompt, cache: KVCache, *,
            align: int = PREFILL_ALIGN, pad_id: int = 0):
    """Right-pad ``prompt`` ``[B, T]`` to ``align`` (capped at the
    cache length), write it into ``cache`` from position 0 and return
    the true last token's logits ``[B, V]`` f32; ``cache.index`` ends
    at ``T``."""
    b, t = prompt.shape
    t_pad = min(cache.length, _ceil_to(t, align))
    padded = torch.full((b, t_pad), pad_id, dtype=torch.long,
                        device=prompt.device)
    padded[:, :t] = prompt
    cache.index = 0
    logits, _ = dec(padded, cache=cache, last_index=t - 1)
    cache.index = t
    return logits[:, -1].float()


def decode_step(dec: TransformerLM, cache: KVCache, tok, *,
                slot_pos=None, temperature: float = 0.0,
                top_k: Optional[int] = None, top_p: Optional[float] = None,
                generator=None):
    """One cached T=1 step: feeds ``tok`` ``[B]``, writes the cache in
    place and returns the next token ``[B]``.  ``slot_pos`` ``[B]``
    gives each row its own cache position (continuous batching);
    ``None`` is the scalar-index contract."""
    logits, _ = dec(tok[:, None], cache=cache, slot_pos=slot_pos)
    return _select(logits[:, -1].float(), temperature, top_k, top_p,
                   generator)


@torch.no_grad()
def generate(model, prompt, *, max_new_tokens: int,
             temperature: float = 0.0, top_k: Optional[int] = None,
             top_p: Optional[float] = None,
             generator: Optional[torch.Generator] = None,
             eos_id: Optional[int] = None, pad_id: int = 0, device=None):
    """Generate ``max_new_tokens`` continuations of ``prompt``.

    Args:
      model: a ``TransformerLM`` (runs where its weights are), or a
        ``ModelSpec``/config dict, built on ``device`` (default
        ``cuda``; raises without a card unless ``device="cpu"``).
      prompt: ``[B, T_prompt]`` token ids (tensor or array).
      max_new_tokens: tokens to append; ``T_prompt + max_new_tokens``
        must fit ``max_len``.
      temperature: 0 = greedy argmax; > 0 = softmax sampling, drawn
        from ``generator``.
      top_k / top_p: sampling filters (both may apply).
      eos_id: rows that emit it are finished: the ``eos_id`` appears
        and every later position is ``pad_id``.
      pad_id: post-eos filler and prompt padding.

    Returns ``[B, T_prompt + max_new_tokens]`` int32 on the model's
    device: prompt + generated.
    """
    dec = _decode_model(model, device)
    dev = dec.embed.weight.device
    prompt = torch.as_tensor(prompt).to(dev, torch.long)
    if prompt.dim() != 2 or prompt.shape[1] < 1:
        raise ValueError(
            f"prompt must be [B, T_prompt>=1]; got {tuple(prompt.shape)}")
    if max_new_tokens < 1:
        raise ValueError(
            f"max_new_tokens must be >= 1; got {max_new_tokens}")
    total = prompt.shape[1] + int(max_new_tokens)
    if total > dec.max_len:
        raise ValueError(
            f"prompt ({prompt.shape[1]}) + max_new_tokens "
            f"({max_new_tokens}) = {total} exceeds max_len={dec.max_len}")
    if top_k is not None and not 1 <= top_k <= dec.vocab_size:
        raise ValueError(f"top_k={top_k} out of range [1, {dec.vocab_size}]")
    if top_p is not None and not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p={top_p} out of range (0, 1]")
    for name, tok in (("eos_id", eos_id), ("pad_id", pad_id)):
        if tok is not None and not 0 <= tok < dec.vocab_size:
            raise ValueError(
                f"{name}={tok} outside vocab [0, {dec.vocab_size})")
    cache = dec.new_cache(prompt.shape[0])
    sample = dict(temperature=temperature, top_k=top_k, top_p=top_p,
                  generator=generator)
    tok = _select(prefill(dec, prompt, cache, pad_id=pad_id), **sample)
    done = (tok == eos_id if eos_id is not None
            else torch.zeros_like(tok, dtype=torch.bool))
    new = [tok]
    for _ in range(int(max_new_tokens) - 1):
        nxt = decode_step(dec, cache, tok, **sample)
        if eos_id is not None:
            nxt = torch.where(done, torch.full_like(nxt, pad_id), nxt)
            done = done | (nxt == eos_id)
        new.append(nxt)
        tok = nxt
    return torch.cat([prompt, torch.stack(new, dim=1)], dim=1).int()
