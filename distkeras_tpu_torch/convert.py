"""Parameter mapping from the JAX package's flax tree to the port.

``params_from_flax(tree)`` takes the ``params`` tree of a JAX
``TransformerLM`` as nested mappings of numpy arrays and returns the
port's ``state_dict``:

* ``Embed_0/embedding [V, d]`` -> ``embed.weight``;
  ``pos_embed/embedding [max_len, d]`` -> ``pos_embed.weight``;
* ``Block_i/LayerNorm_{0,1}/{scale,bias}`` -> ``blocks.i.ln{1,2}.*``;
* ``Block_i/SelfAttention_0/{query,key,value}/kernel [d, H|KVH, hd]``
  and ``bias [H|KVH, hd]`` -> ``blocks.i.attn.*.weight [H*hd, d]`` /
  ``bias [H*hd]``; ``out/kernel [H, hd, d]`` -> ``out.weight
  [d, H*hd]``;
* ``Block_i/Dense_{0,1}/kernel [in, out]`` -> ``blocks.i.mlp_{in,out}
  .weight [out, in]``;
* ``LayerNorm_0`` -> ``ln_f``; ``lm_head/kernel [d, V]`` ->
  ``lm_head.weight [V, d]``.

Values stay f32 here; ``TransformerLM.load_state_dict`` casts each to
its parameter's dtype.  ``params_to_flax(state_dict, num_heads)`` is
the reverse (f32 numpy leaves), so trained parameters can be compared
with the JAX package's.

The MLP, ConvNet, ResNet, Wide & Deep and BiLSTM keep flax's module
names, so their trees map leaf by leaf: a path ``A/B/kernel`` becomes
``A.B.weight`` (conv HWIO -> OIHW, Dense ``[in, out]`` -> ``[out,
in]``, the LSTM cells' gate kernels alike); ``bias``, a norm's
``scale`` and an embedding table's ``embedding`` keep their names and
values.  An LM tree is told apart by its ``pos_embed``/``lm_head``
(``_is_lm_tree``), not by ``Embed_0``, which the BiLSTM's has too.
Both GroupNorm spellings map as they nest:
``AdaptiveGroupNorm_i/GroupNorm_0/scale`` (``norm="group"``) and
``AdaptiveGroupNorm_i/scale``
(``norm="group_pallas"``).  The fused bottleneck's raw ``[C_in, C_out]``
kernels (``conv1``, ``convd``, ``conv3``) keep flax's layout, the one its
kernels read, so they copy unchanged both ways.

``variables_from_flax({"params": ..., "batch_stats": ...})`` adds the
ResNet's ``norm="batch"`` running statistics: flax's
``batch_stats/_BatchNormRelu_i/BatchNorm_0/{mean,var}`` are the port's
buffers of the same path, leaf by leaf.  ``variables_to_flax`` is the
reverse; ``params_to_flax`` leaves the statistics out.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from distkeras_tpu_torch import serialization


def _t(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    return torch.tensor(np.asarray(x))


def _dense(node: Mapping, prefix: str) -> dict:
    kernel = np.asarray(node["kernel"])
    return {f"{prefix}.weight": _t(kernel.reshape(kernel.shape[0], -1).T),
            f"{prefix}.bias": _t(np.asarray(node["bias"]).reshape(-1))}


def _layer_norm(node: Mapping, prefix: str) -> dict:
    return {f"{prefix}.scale": _t(node["scale"]),
            f"{prefix}.bias": _t(node["bias"])}


def _kernel_from_flax(k: np.ndarray) -> np.ndarray:
    if k.ndim == 4:                                # conv HWIO -> OIHW
        return k.transpose(3, 2, 0, 1)
    if k.ndim == 2:                                # Dense [in, out]
        return k.T
    raise ValueError(f"no torch layout for a {k.ndim}-d flax kernel")


def _flat_from_flax(tree: Mapping, prefix: str = "") -> dict:
    sd = {}
    for key, node in tree.items():
        if isinstance(node, Mapping):
            sd.update(_flat_from_flax(node, f"{prefix}{key}."))
        elif key == "kernel":
            sd[f"{prefix}weight"] = _t(np.ascontiguousarray(
                _kernel_from_flax(np.asarray(node))))
        else:
            sd[f"{prefix}{key}"] = _t(node)
    return sd


def _is_lm_tree(tree: Mapping) -> bool:
    """A ``TransformerLM`` tree: it has the LM's own top-level keys
    (``pos_embed``, ``lm_head``).  ``Embed_0`` alone does not tell: the
    BiLSTM's tree has it too."""
    return "pos_embed" in tree or "lm_head" in tree


def params_from_flax(tree: Mapping) -> dict:
    """flax params (numpy leaves) -> the port's ``state_dict``: a
    ``TransformerLM`` tree (``_is_lm_tree``), else an MLP, ConvNet,
    ResNet, Wide & Deep or BiLSTM tree mapped leaf by leaf.  Raises on
    an LM tree it does not know (MoE, stacked ``scan_blocks`` layers)."""
    tree = tree.get("params", tree)
    if not _is_lm_tree(tree):
        return _flat_from_flax(tree)
    sd = {"embed.weight": _t(tree["Embed_0"]["embedding"]),
          "pos_embed.weight": _t(tree["pos_embed"]["embedding"])}
    n_blocks = sum(1 for k in tree if k.startswith("Block_"))
    expected = {"Embed_0", "pos_embed", "LayerNorm_0", "lm_head",
                *(f"Block_{i}" for i in range(n_blocks))}
    if set(tree) != expected:
        raise ValueError(
            f"not a per-layer dense TransformerLM param tree: unexpected "
            f"keys {sorted(set(tree) - expected)}, missing "
            f"{sorted(expected - set(tree))}")
    for i in range(n_blocks):
        blk, pre = tree[f"Block_{i}"], f"blocks.{i}"
        att = blk["SelfAttention_0"]
        sd.update(_layer_norm(blk["LayerNorm_0"], f"{pre}.ln1"))
        sd.update(_layer_norm(blk["LayerNorm_1"], f"{pre}.ln2"))
        for name in ("query", "key", "value"):
            sd.update(_dense(att[name], f"{pre}.attn.{name}"))
        out = np.asarray(att["out"]["kernel"])
        sd[f"{pre}.attn.out.weight"] = _t(out.reshape(-1, out.shape[-1]).T)
        sd[f"{pre}.attn.out.bias"] = _t(att["out"]["bias"])
        sd.update(_dense(blk["Dense_0"], f"{pre}.mlp_in"))
        sd.update(_dense(blk["Dense_1"], f"{pre}.mlp_out"))
    sd.update(_layer_norm(tree["LayerNorm_0"], "ln_f"))
    sd.update(_dense(tree["lm_head"], "lm_head"))
    return sd


def variables_from_flax(variables: Mapping) -> dict:
    """flax variables (``params`` and, for ``norm="batch"``,
    ``batch_stats``; numpy leaves) -> the port's ``state_dict``, the
    statistics as buffers."""
    return {**params_from_flax(variables["params"]),
            **_flat_from_flax(variables.get("batch_stats", {}))}


def is_batch_stat(name: str) -> bool:
    """A BatchNorm running statistic (``..BatchNorm_0.mean``/``.var``)."""
    *path, leaf = name.split(".")
    return leaf in ("mean", "var") and bool(path) \
        and path[-1].startswith("BatchNorm_")


def _f32(x) -> torch.Tensor:
    """An f32 tensor where ``x`` lives (the value itself if it is one)."""
    return torch.as_tensor(x).detach().float()


def _dense_to_flax(sd: Mapping, prefix: str, heads: int | None = None
                   ) -> dict:
    kernel = _f32(sd[f"{prefix}.weight"]).T                   # [in, out]
    bias = _f32(sd[f"{prefix}.bias"])
    if heads is not None:
        kernel = kernel.reshape(kernel.shape[0], heads, -1)
        bias = bias.reshape(heads, -1)
    return {"kernel": kernel, "bias": bias}


def _layer_norm_to_flax(sd: Mapping, prefix: str) -> dict:
    return {"scale": _f32(sd[f"{prefix}.scale"]),
            "bias": _f32(sd[f"{prefix}.bias"])}


def _flat_to_flax(state_dict: Mapping) -> dict:
    tree: dict = {}
    for name, value in state_dict.items():
        *path, key = name.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        x = _f32(value)
        if key == "weight":
            key = "kernel"
            x = x.permute(*((2, 3, 1, 0) if x.ndim == 4 else (1, 0)))
        node[key] = x
    return tree


def _params(sd: Mapping, num_heads: int | None) -> dict:
    """The flax ``params`` tree of ``sd``, its leaves f32 tensors where
    the values live (views of them where the layouts allow)."""
    if "embed.weight" not in sd:
        return _flat_to_flax({k: v for k, v in sd.items()
                              if not is_batch_stat(k)})
    if num_heads is None:
        raise ValueError("a TransformerLM state_dict needs num_heads")
    n_blocks = len({k.split(".")[1] for k in sd if k.startswith("blocks.")})
    d = sd["embed.weight"].shape[1]
    hd = d // num_heads
    tree = {"Embed_0": {"embedding": _f32(sd["embed.weight"])},
            "pos_embed": {"embedding": _f32(sd["pos_embed.weight"])},
            "LayerNorm_0": _layer_norm_to_flax(sd, "ln_f"),
            "lm_head": _dense_to_flax(sd, "lm_head")}
    for i in range(n_blocks):
        pre = f"blocks.{i}"
        kvh = sd[f"{pre}.attn.key.weight"].shape[0] // hd
        att = {name: _dense_to_flax(sd, f"{pre}.attn.{name}", heads)
               for name, heads in (("query", num_heads), ("key", kvh),
                                   ("value", kvh))}
        out = _f32(sd[f"{pre}.attn.out.weight"]).T            # [H*hd, d]
        att["out"] = {"kernel": out.reshape(num_heads, hd, -1),
                      "bias": _f32(sd[f"{pre}.attn.out.bias"])}
        tree[f"Block_{i}"] = {
            "LayerNorm_0": _layer_norm_to_flax(sd, f"{pre}.ln1"),
            "LayerNorm_1": _layer_norm_to_flax(sd, f"{pre}.ln2"),
            "SelfAttention_0": att,
            "Dense_0": _dense_to_flax(sd, f"{pre}.mlp_in"),
            "Dense_1": _dense_to_flax(sd, f"{pre}.mlp_out")}
    return tree


def params_to_flax(state_dict: Mapping, num_heads: int | None = None
                   ) -> dict:
    """The port's ``state_dict`` -> the JAX model's ``params`` tree
    (nested dicts of f32 numpy arrays), the reverse of
    ``params_from_flax``.  For a ``TransformerLM``, ``num_heads`` splits
    the fused projections into flax's ``[d, H, head_dim]`` kernels (the
    K/V head count follows from the key projection's width); the MLP,
    ConvNet and ResNet need no more than their ``state_dict``."""
    return serialization.to_host(_params(state_dict, num_heads))


def _staged(leaf, device: torch.device) -> torch.Tensor:
    """A host numpy leaf as a tensor on ``device``: for a card, one copy
    into pinned memory, then a copy to the card without waiting (the
    pinned block is not reused until that copy is done)."""
    a = np.asarray(leaf)
    if device.type != "cuda":
        return torch.from_numpy(np.array(a))
    host = torch.empty(a.shape, dtype=torch.from_numpy(a[:0].copy()).dtype,
                       pin_memory=True)
    host.numpy()[...] = a
    return host.to(device, non_blocking=True)


def copy_from_flax(params: Mapping[str, torch.Tensor], tree: Mapping,
                   num_heads: int | None = None) -> None:
    """Copy a flax ``params`` tree of host numpy leaves (a parameter
    server's pull) into the port's parameter tensors ``params``, in
    place, on their device: each leaf goes to the device as it is and is
    laid out there (conv HWIO -> OIHW, Dense ``[in, out]`` -> ``[out,
    in]``), the reverse of ``params_tree``.  A ``TransformerLM`` tree is
    mapped on the host (``params_from_flax``) first."""
    with torch.no_grad():
        if "embed.weight" in params:
            src = params_from_flax(tree)
            for name, p in params.items():
                p.copy_(src[name])
            return
        for name, p in params.items():
            *path, key = name.split(".")
            node = tree
            for part in path:
                node = node[part]
            t = _staged(node["kernel" if key == "weight" else key], p.device)
            if key == "weight":
                if t.ndim not in (2, 4):
                    raise ValueError(
                        f"no torch layout for a {t.ndim}-d flax kernel")
                t = t.permute(*((3, 2, 0, 1) if t.ndim == 4 else (1, 0)))
            p.copy_(t)


def variables_to_flax(state_dict: Mapping) -> dict:
    """The port's MLP, ConvNet or ResNet ``state_dict`` -> flax variables
    ``{"params": ...}``, plus ``"batch_stats"`` where it holds BatchNorm
    statistics: the reverse of ``variables_from_flax``."""
    out = {"params": _params(state_dict, None)}
    stats = {k: v for k, v in state_dict.items() if is_batch_stat(k)}
    if stats:
        out["batch_stats"] = _flat_to_flax(stats)
    return serialization.to_host(out)


# -- training states --------------------------------------------------------
#
# The JAX package checkpoints its ``TrainState`` (``distkeras_tpu/
# workers.py``) as the state dict ``{"step", "params", "opt_state",
# "model_state", "rng"}``: ``step`` an int32 scalar, ``params`` the flax
# tree, ``opt_state`` optax's chain (``{"0": .., "1": ..}``, each
# transformation's named fields over trees of the params' layout: the
# port's ``Optimizer.chain``), ``model_state`` ``{"batch_stats": ..}`` or
# ``{}``, ``rng`` a threefry key as its raw ``uint32[2]`` data.  Dicts
# are in key order, as ``jax.device_get`` leaves them.  The PS trainers
# stack their workers' states on a leading axis.
#
# Key leaves: the port's streams are ``torch.Generator``s, whose state
# no threefry key can hold.  The port writes into a key leaf the 64-bit
# seed of the stream it stands for, high word first: the data that
# ``jax.random.key(seed)`` holds, so the JAX package can wrap it, and
# the port can seed a stream from a JAX key the same way
# (``stream_from_key``).  The streams' exact positions ride beside the
# state, in the port's own entry of the checkpoint (``checkpoint.py``).


def seed_key(seed: int) -> np.ndarray:
    """The key leaf of a stream seeded with ``seed``: ``uint32[2]``
    (high word, low word), ``jax.random.key(seed)``'s data."""
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF],
                    np.uint32)


def stream_key(gen: torch.Generator | None) -> np.ndarray:
    """The key leaf of a stream (zeros for a state without one)."""
    return seed_key(0 if gen is None else gen.initial_seed())


def stream_from_key(key, device=None) -> torch.Generator:
    """A stream seeded from a key leaf's two words."""
    hi, lo = (int(w) for w in np.asarray(key, np.uint32).reshape(-1)[-2:])
    return torch.Generator(device=device).manual_seed((hi << 32) | lo)


def params_tree(state_dict: Mapping, num_heads: int | None = None) -> dict:
    """``params_to_flax`` as a JAX tree holds it (dicts in key order),
    its leaves f32 tensors where the values live, for the writers:
    ``serialization.to_host`` copies them to the host all at once."""
    return serialization.sort_keys(_params(state_dict, num_heads))


def train_state_to_flax(state, chain: tuple,
                        num_heads: int | None = None) -> dict:
    """The port's ``TrainState`` -> the JAX ``TrainState``'s state dict.
    ``chain``: the optimizer's optax layout (``Optimizer.chain``).
    Tensor leaves stay where they are, as f32 (views where the layouts
    allow)."""
    if not chain:
        raise ValueError("the optimizer has no optax layout (chain); "
                         "only the named optimizers checkpoint")

    count = np.asarray(state.opt_state["count"], np.int32)
    opt = {str(i): {slot: count if slot == "count"
                    else params_tree(state.opt_state[slot], num_heads)
                    for slot in slots}
           for i, slots in enumerate(chain)}
    stats = {k: v for k, v in state.model_state.items()
             if is_batch_stat(k)}
    return {"step": np.asarray(state.step, np.int32),
            "params": params_tree(state.params, num_heads),
            "opt_state": opt,
            "model_state": ({"batch_stats": serialization.sort_keys(
                _flat_to_flax(stats))} if stats else {}),
            "rng": stream_key(state.rng)}


def _copy_into(dst: Mapping, src: Mapping) -> None:
    with torch.no_grad():
        for name, t in dst.items():
            t.copy_(_t(src[name]))


def train_state_from_flax(tree: Mapping, state, chain: tuple) -> None:
    """Fill the port's ``state`` (built for the same model and
    optimizer) IN PLACE from a JAX ``TrainState`` state dict, the
    reverse of ``train_state_to_flax``.  The stream is left alone (see
    ``stream_from_key``)."""
    _copy_into(state.params, params_from_flax(tree["params"]))
    counts = []
    for i, slots in enumerate(chain):
        node = tree["opt_state"][str(i)]
        for slot in slots:
            if slot == "count":
                counts.append(int(np.asarray(node["count"])))
            else:
                _copy_into(state.opt_state[slot],
                           params_from_flax(node[slot]))
    if counts:
        state.opt_state["count"] = counts[0]
    stats = tree["model_state"].get("batch_stats", {})
    if stats:
        _copy_into({k: v for k, v in state.model_state.items()
                    if is_batch_stat(k)}, _flat_from_flax(stats))
    state.step = int(np.asarray(tree["step"]))


def stack_trees(trees: list):
    """Leafwise stack of equal host trees (numpy leaves) on a new leading
    axis, the JAX PS trainers' worker axis."""
    first = trees[0]
    if isinstance(first, Mapping):
        return {k: stack_trees([t[k] for t in trees]) for k in first}
    return np.stack([np.asarray(t) for t in trees])


def index_tree(tree, i: int):
    """Row ``i`` of every leaf: one worker of a stacked tree."""
    if isinstance(tree, Mapping):
        return {k: index_tree(v, i) for k, v in tree.items()}
    return tree[i]
