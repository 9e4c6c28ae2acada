"""Speculative decoding for ``serving.DecodeEngine``: the proposers and
the acceptance rule, the port of ``distkeras_tpu/speculative.py``.

A proposer guesses the next ``k`` tokens and one dense verify pass of
the target scores all ``k + 1`` positions; the greedy acceptance rule
commits the longest prefix the target itself would have produced plus
one bonus token, so the output equals plain greedy decode.

* ``"ngram"``: prompt-lookup over the slot's token ledger (prompt and
  generated tokens): the last ``ngram`` tokens are matched against the
  ledger's history and the tokens that followed the most recent earlier
  match are proposed.
* ``"draft"``: a smaller ``TransformerLM`` of the same vocab runs cached
  greedy T=1 steps for every slot at once, with its own per-pool
  envelope cache.  Draft KV is recompute-class: never swapped out by
  preemption, rebuilt from the ledger by one prefill whenever it is
  invalidated (admission, readmission, weight swap).
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from distkeras_tpu_torch.models.generate import _decode_model, decode_step

#: accepted ``proposer`` spellings for ``DecodeEngine(speculative=)``
PROPOSERS = ("ngram", "draft")


def normalize(cfg, *, vocab_size: int, max_len: int,
              device=None) -> Optional[dict]:
    """Validate a ``speculative=`` engine config; returns ``None`` (off)
    or a dict with ``proposer``, ``k`` (window, >= 1), ``ngram`` (match
    length, >= 1), ``draft_model`` (a ``TransformerLM`` or None) and
    ``draft_variables`` (None, or a mapping in the draft's
    ``state_dict`` keys: the weights the draft runs with, in place of
    its own).  The draft must share the target's vocab and cover its
    ``max_len``."""
    if cfg is None:
        return None
    if not isinstance(cfg, Mapping):
        raise ValueError(
            f"speculative must be a mapping (or None); got "
            f"{type(cfg).__name__}")
    unknown = set(cfg) - {"proposer", "k", "ngram", "draft_model",
                          "draft_variables"}
    if unknown:
        raise ValueError(
            f"speculative config has unknown keys {sorted(unknown)}; "
            "expected proposer/k/ngram/draft_model/draft_variables")
    proposer = cfg.get("proposer", "ngram")
    if proposer not in PROPOSERS:
        raise ValueError(
            f"speculative proposer must be one of {PROPOSERS}; got "
            f"{proposer!r}")
    k = int(cfg.get("k", 4))
    if k < 1:
        raise ValueError(f"speculative k must be >= 1; got {k}")
    ngram = int(cfg.get("ngram", 2))
    if ngram < 1:
        raise ValueError(f"speculative ngram must be >= 1; got {ngram}")
    out = {"proposer": proposer, "k": k, "ngram": ngram,
           "draft_model": None, "draft_variables": None}
    if proposer == "draft":
        if cfg.get("draft_model") is None:
            raise ValueError(
                "speculative proposer 'draft' needs a draft_model")
        draft = _decode_model(cfg["draft_model"], device)
        if draft.vocab_size != vocab_size:
            raise ValueError(
                f"draft_model vocab_size={draft.vocab_size} must equal "
                f"the target's ({vocab_size}): the acceptance rule "
                "compares token ids")
        if draft.max_len < max_len:
            raise ValueError(
                f"draft_model max_len={draft.max_len} must cover the "
                f"target's max_len={max_len}: every bucket envelope "
                "holds a draft cache of its own length")
        out["draft_model"] = draft
        dvars = cfg.get("draft_variables")
        if dvars is not None:
            own = draft.state_dict()
            if set(dvars) != set(own):
                raise ValueError(
                    "draft_variables must hold the draft model's "
                    f"state_dict keys; missing "
                    f"{sorted(set(own) - set(dvars))[:4]}, unknown "
                    f"{sorted(set(dvars) - set(own))[:4]}")
            dev = draft.embed.weight.device
            out["draft_variables"] = {
                n: torch.as_tensor(v if isinstance(v, torch.Tensor)
                                   else np.asarray(v)).to(dev, own[n].dtype)
                for n, v in dvars.items()}
    return out


def ngram_propose(ledger: np.ndarray, k: int, n: int) -> np.ndarray:
    """Prompt-lookup drafting over one slot's token ledger: the last
    ``n`` tokens matched against every earlier position (the most recent
    match wins), and up to ``k`` tokens that followed it proposed.
    Returns int32 of length 0..k; empty means no guess."""
    ledger = np.asarray(ledger, np.int32)
    t = len(ledger)
    if t < n + 1:
        return np.empty((0,), np.int32)
    pat = ledger[t - n:]
    # a match ending at the tail is the pattern itself
    for s in range(t - n - 1, -1, -1):
        if np.array_equal(ledger[s:s + n], pat):
            lo = s + n
            return ledger[lo:lo + k].copy()
    return np.empty((0,), np.int32)


@torch.no_grad()
def draft_propose(call, cache, tok, pos, live, *, env: int, k: int,
                  pad_id: int):
    """``k`` greedy draft proposals for every slot at once: ``k + 1``
    cached T=1 steps of ``call`` (the draft's forward) over ``cache``
    at per-slot positions, returning ``[k, slots]`` int64.  Dead slots
    (``live`` False) rewrite row ``env - 1``, which a live slot never
    reaches (the engine drafts only while ``max_new - generated > k``,
    and routing keeps ``prompt + max_new <= env``).  Step ``k`` writes
    the k-th proposal's own K/V row and its output is dropped: after
    any commit length, full acceptance included, the draft cache holds
    rows ``0..L-2`` and its feed is the ledger's last token."""
    props = []
    for _ in range(k + 1):
        step_pos = torch.where(live, pos.clamp(max=env - 1),
                               torch.full_like(pos, env - 1))
        nxt = decode_step(call, cache, tok, slot_pos=step_pos)
        nxt = torch.where(live, nxt, torch.full_like(nxt, pad_id))
        props.append(nxt)
        tok, pos = nxt, pos + 1
    return torch.stack(props[:k])


@torch.no_grad()
def draft_prefill(call, slot_cache, tokens) -> None:
    """Rebuild one slot's draft cache: ``tokens`` ``[1, t_pad]`` (the
    ledger but its last token, right-padded) run from position 0 through
    ``call`` into ``slot_cache`` (views of the slot's rows), whose whole
    envelope is replaced first."""
    for t in slot_cache.leaves():
        t.zero_()
    slot_cache.index = 0
    call(tokens, cache=slot_cache)


def accept_length(proposed, greedy) -> int:
    """The greedy acceptance rule: the longest prefix of ``proposed``
    the target would itself have generated (``greedy[j]`` is its argmax
    after ``j`` proposals).  Position ``n`` of ``greedy`` is always
    committable as the bonus token."""
    n = 0
    for j in range(len(proposed)):
        if int(proposed[j]) != int(greedy[j]):
            break
        n += 1
    return n
