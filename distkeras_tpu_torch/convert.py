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

The MLP, ConvNet and ResNet keep flax's module names, so their trees
map leaf by leaf: a path ``A/B/kernel`` becomes ``A.B.weight`` (conv
HWIO -> OIHW, Dense ``[in, out]`` -> ``[out, in]``); ``bias`` and a
norm's ``scale`` keep their names and values.  Both GroupNorm
spellings map as they nest: ``AdaptiveGroupNorm_i/GroupNorm_0/scale``
(``norm="group"``) and ``AdaptiveGroupNorm_i/scale``
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


def _t(x) -> torch.Tensor:
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


def params_from_flax(tree: Mapping) -> dict:
    """flax params (numpy leaves) -> the port's ``state_dict``: a
    ``TransformerLM`` tree (it has ``Embed_0``), else an MLP, ConvNet or
    ResNet tree mapped leaf by leaf.  Raises on an LM tree it does not
    know (MoE, stacked ``scan_blocks`` layers)."""
    tree = tree.get("params", tree)
    if "Embed_0" not in tree:
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


def _is_batch_stat(name: str) -> bool:
    """A BatchNorm running statistic (``..BatchNorm_0.mean``/``.var``)."""
    *path, leaf = name.split(".")
    return leaf in ("mean", "var") and bool(path) \
        and path[-1].startswith("BatchNorm_")


def _np(x) -> np.ndarray:
    return torch.as_tensor(x).detach().float().cpu().numpy()


def _dense_to_flax(sd: Mapping, prefix: str, heads: int | None = None
                   ) -> dict:
    kernel = _np(sd[f"{prefix}.weight"]).T                    # [in, out]
    bias = _np(sd[f"{prefix}.bias"])
    if heads is not None:
        kernel = kernel.reshape(kernel.shape[0], heads, -1)
        bias = bias.reshape(heads, -1)
    return {"kernel": kernel, "bias": bias}


def _layer_norm_to_flax(sd: Mapping, prefix: str) -> dict:
    return {"scale": _np(sd[f"{prefix}.scale"]),
            "bias": _np(sd[f"{prefix}.bias"])}


def _flat_to_flax(state_dict: Mapping) -> dict:
    tree: dict = {}
    for name, value in state_dict.items():
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        x = _np(value)
        if leaf == "weight":
            leaf = "kernel"
            x = x.transpose(2, 3, 1, 0) if x.ndim == 4 else x.T
        node[leaf] = np.ascontiguousarray(x)
    return tree


def params_to_flax(state_dict: Mapping, num_heads: int | None = None
                   ) -> dict:
    """The port's ``state_dict`` -> the JAX model's ``params`` tree
    (nested dicts of f32 numpy arrays), the reverse of
    ``params_from_flax``.  For a ``TransformerLM``, ``num_heads`` splits
    the fused projections into flax's ``[d, H, head_dim]`` kernels (the
    K/V head count follows from the key projection's width); the MLP,
    ConvNet and ResNet need no more than their ``state_dict``."""
    sd = state_dict
    if "embed.weight" not in sd:
        return _flat_to_flax({k: v for k, v in sd.items()
                              if not _is_batch_stat(k)})
    if num_heads is None:
        raise ValueError("a TransformerLM state_dict needs num_heads")
    n_blocks = len({k.split(".")[1] for k in sd if k.startswith("blocks.")})
    d = sd["embed.weight"].shape[1]
    hd = d // num_heads
    tree = {"Embed_0": {"embedding": _np(sd["embed.weight"])},
            "pos_embed": {"embedding": _np(sd["pos_embed.weight"])},
            "LayerNorm_0": _layer_norm_to_flax(sd, "ln_f"),
            "lm_head": _dense_to_flax(sd, "lm_head")}
    for i in range(n_blocks):
        pre = f"blocks.{i}"
        kvh = sd[f"{pre}.attn.key.weight"].shape[0] // hd
        att = {name: _dense_to_flax(sd, f"{pre}.attn.{name}", heads)
               for name, heads in (("query", num_heads), ("key", kvh),
                                   ("value", kvh))}
        out = _np(sd[f"{pre}.attn.out.weight"]).T              # [H*hd, d]
        att["out"] = {"kernel": out.reshape(num_heads, hd, -1),
                      "bias": _np(sd[f"{pre}.attn.out.bias"])}
        tree[f"Block_{i}"] = {
            "LayerNorm_0": _layer_norm_to_flax(sd, f"{pre}.ln1"),
            "LayerNorm_1": _layer_norm_to_flax(sd, f"{pre}.ln2"),
            "SelfAttention_0": att,
            "Dense_0": _dense_to_flax(sd, f"{pre}.mlp_in"),
            "Dense_1": _dense_to_flax(sd, f"{pre}.mlp_out")}
    return tree


def variables_to_flax(state_dict: Mapping) -> dict:
    """The port's MLP, ConvNet or ResNet ``state_dict`` -> flax variables
    ``{"params": ...}``, plus ``"batch_stats"`` where it holds BatchNorm
    statistics: the reverse of ``variables_from_flax``."""
    out = {"params": params_to_flax(state_dict)}
    stats = {k: v for k, v in state_dict.items() if _is_batch_stat(k)}
    if stats:
        out["batch_stats"] = _flat_to_flax(stats)
    return out
