"""The port's ResNet, MLP and ConvNet against the JAX package's, and
``convert`` for their trees.

Weights are drawn at random for the port's model (norm scales around 1,
so the zero-initialized last norm of a block does not hide the block's
branch) and carried to the JAX model through ``convert.params_to_flax``;
both see the same numpy input.  Logits
agree within 1e-4 of their rms in f32 and 2e-2 in bf16 (the two round
activations to bf16 at different places; flax's GroupNorm and
``F.group_norm`` also order the affine differently).  The tiny
configurations reach each padding trap: flax ``"SAME"`` pads a stride-2
3x3 conv and the stride-2 max pool of an even size ``(0, 1)``, and the
s2d stem pads ``[(2, 1), (2, 1)]``."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu.models import ModelSpec
from distkeras_tpu.models import model_config as jax_config
from distkeras_tpu.models.resnet import s2d_input as jax_s2d_input
from distkeras_tpu.models.resnet import s2d_stem_kernel as jax_s2d_kernel
from distkeras_tpu_torch import build_model, convert
from distkeras_tpu_torch.models import model_config
from distkeras_tpu_torch.models.resnet import s2d_input, s2d_stem_kernel

jax.config.update("jax_platforms", "cpu")
# tiny shapes: one thread each keeps the parallel test workers off
# each other's cores
torch.set_num_threads(1)

TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _jax_model(family, shape, **kw):
    return ModelSpec.from_config(jax_config(family, shape, **kw)).build()


def _forward_parity(family, shape, kw, dtype="float32", seed=0):
    """Random weights drawn for the port's model (norm scales around 1,
    so no block branch starts at zero), carried to the JAX model by
    ``convert.params_to_flax``; logits of both on one numpy input."""
    port = build_model(model_config(family, shape, **kw), device="cpu")
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in port.state_dict().items():
        noise = rng.standard_normal(v.shape).astype(np.float32)
        sd[k] = torch.from_numpy(
            noise * 0.3 + (k.endswith("scale")) if v.dim() == 1
            else noise * v.std().item())
    port.load_state_dict(sd)
    x = rng.standard_normal((2, *shape)).astype(np.float32)
    model = _jax_model(family, shape, **kw)
    want = np.asarray(jax.jit(model.apply)(
        {"params": convert.params_to_flax(sd)}, x), np.float32)
    with torch.no_grad():
        got = port(torch.tensor(x)).float().numpy()
    rms = np.sqrt(np.mean(want ** 2))
    assert np.abs(got - want).max() <= TOL[dtype] * rms, (
        np.abs(got - want).max(), rms)


CASES = list(itertools.product((False, True), ("group", "group_pallas",
                                                "none"),
                               ("conv", "space_to_depth")))


@pytest.mark.parametrize("bottleneck,norm,stem", CASES)
def test_resnet_forward_matches_jax(bottleneck, norm, stem):
    """f32 for every case; bf16 for one stem of each block and norm (at
    32 px: at 16 px the last stage normalizes groups of one channel over
    2x2 pixels, where the two variance formulas part by more than bf16's
    rounding)."""
    dtypes = ["float32"]
    if stem == ("space_to_depth" if bottleneck else "conv"):
        dtypes.append("bfloat16")
    for dtype in dtypes:
        _forward_parity("resnet", (32, 32, 3), dict(
            num_classes=5, stage_sizes=(1, 1), bottleneck=bottleneck,
            width=16, norm=norm, stem=stem, dtype=dtype), dtype)


def test_mlp_and_convnet_forward_match_jax():
    _forward_parity("mlp", (8,), dict(num_classes=4, hidden=(32, 16)))
    _forward_parity("convnet", (16, 16, 3), dict(num_classes=4,
                                                 widths=(8, 16), dense=32))


ROUND_TRIPS = {"group": dict(norm="group"),
               "group_pallas": dict(norm="group_pallas"),
               "pallas_block": dict(fusion="pallas_block"),
               "pallas_tail": dict(fusion="pallas_tail"),
               "fusion_stages": dict(fusion="pallas_block",
                                     fusion_stages=(1,))}


@pytest.mark.parametrize("norm", list(ROUND_TRIPS))
def test_convert_round_trip_for_both_group_norm_nestings(norm):
    """The port's tree has the JAX model's paths and shapes, with
    ``GroupNorm_0`` nested for ``norm="group"`` only, and maps both ways
    without loss; so do the fused trees (``pallas_block``'s raw ``[C_in,
    C_out]`` kernels, ``pallas_tail``'s nested ``conv1u``/``gn1u``, and
    ``fusion_stages``' blocks numbered per class)."""
    kw = dict(num_classes=3, stage_sizes=(1, 1), bottleneck=True, width=16,
              **ROUND_TRIPS[norm])
    sd = build_model(model_config("resnet", (16, 16, 3), **kw),
                     device="cpu").state_dict()
    nested = [k for k in sd if "AdaptiveGroupNorm" in k]
    assert nested and all((".GroupNorm_0." in k) == (norm != "group_pallas")
                          for k in nested)
    if "fusion" in ROUND_TRIPS[norm]:
        blocks = {k.split(".")[0] for k in sd if "Block_" in k}
        assert blocks == ({"FusedBottleneckBlock_0", "BottleneckBlock_0"}
                          if norm == "fusion_stages" else
                          {"FusedBottleneckBlock_0", "FusedBottleneckBlock_1"})
    tree = convert.params_to_flax(sd)
    shapes = jax.eval_shape(_jax_model("resnet", (16, 16, 3), **kw).init,
                            jax.random.key(0),
                            jnp.zeros((1, 16, 16, 3)))["params"]
    assert jax.tree_util.tree_structure(tree) \
        == jax.tree_util.tree_structure(shapes)
    for a, b in zip(jax.tree_util.tree_leaves(tree),
                    jax.tree_util.tree_leaves(shapes)):
        assert a.shape == b.shape
    back = convert.params_from_flax(tree)
    assert back.keys() == sd.keys()
    for k in sd:
        assert torch.equal(back[k], sd[k]), k


def test_default_init_follows_flax():
    """Each parameter's std and mean against the JAX ResNet's init: conv
    and dense kernels within 10 % of the JAX std (the mean within five
    standard errors of 0) where a draw has >= 4k values; norm scales, norm biases and
    dense biases exactly 1 or 0 — the block's last norm scale 0.  The
    fused model's raw ``[C_in, C_out]`` kernels (``conv1``, ``convd``,
    ``conv3``) are lecun-normal with fan-in ``C_in``, ``gn{1,2,d}_scale``
    ones and ``gn3_scale`` zeros, as flax draws them."""
    for spelling in ({"norm": "group_pallas"}, {"fusion": "pallas_block"}):
        _init_follows_flax(dict(num_classes=64, stage_sizes=(1, 1),
                                bottleneck=True, width=32,
                                stem="space_to_depth", **spelling))


def _init_follows_flax(kw):
    params = jax.jit(_jax_model("resnet", (32, 32, 3), **kw).init)(
        jax.random.key(0), jnp.zeros((1, 32, 32, 3)))["params"]
    want = {jax.tree_util.keystr(p): np.asarray(x) for p, x in
            jax.tree_util.tree_flatten_with_path(params)[0]}
    model = build_model(model_config("resnet", (32, 32, 3), **kw),
                        device="cpu")
    got = {jax.tree_util.keystr(p): x for p, x in
           jax.tree_util.tree_flatten_with_path(
               convert.params_to_flax(model.state_dict()))[0]}
    assert got.keys() == want.keys()
    zero_scales = 0
    for key, w in want.items():
        g = got[key]
        if not key.endswith(("['kernel']", "['conv1']", "['convd']",
                             "['conv3']")):
            np.testing.assert_array_equal(g, w, err_msg=key)
            zero_scales += key.endswith(("['scale']", "['gn3_scale']")) \
                and not w.any()
            continue
        if w.size >= 4096:
            assert abs(g.std() / w.std() - 1) < 0.1, (key, g.std(), w.std())
            # five standard errors of a mean of w.size draws
            assert abs(g.mean()) < 5 * w.std() / np.sqrt(w.size), key
        std = np.prod(w.shape[:-1]) ** -0.5 / 0.87962566103423978
        assert np.abs(g).max() <= 2 * std * 1.0001, key  # cut at 2 std
    assert zero_scales == 2                            # one per block
    assert all(v.dtype == torch.float32 for v in model.state_dict().values())


def test_s2d_helpers_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 6, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        s2d_input(torch.tensor(x)).numpy(), np.asarray(jax_s2d_input(x)))
    w7 = rng.standard_normal((7, 7, 3, 5)).astype(np.float32)
    np.testing.assert_array_equal(
        s2d_stem_kernel(torch.tensor(w7)).numpy(),
        np.asarray(jax_s2d_kernel(jnp.asarray(w7))))


def test_unported_spellings_raise():
    """The spellings the reference refuses raise its errors; the ones
    ported since (``norm="batch"``, dropout) build."""
    base = dict(num_classes=3, stage_sizes=(1,), width=16)
    bn = build_model(model_config("resnet", (16, 16, 3), norm="batch",
                                  **base), device="cpu")
    assert "_BatchNormRelu_0.BatchNorm_0.var" in dict(bn.named_buffers())
    with pytest.raises(ValueError, match="fusion"):
        build_model(model_config("resnet", (16, 16, 3), norm="batch",
                                 fusion="pallas_block", **base),
                    device="cpu")
    fused = build_model(model_config("resnet", (16, 16, 3),
                                     fusion="pallas_block", **base),
                        device="cpu")
    assert fused.block_names == ["FusedBottleneckBlock_0"]
    with pytest.raises(ValueError, match="fusion"):
        build_model(model_config("resnet", (16, 16, 3), bottleneck=False,
                                 fusion="pallas_block", **base),
                    device="cpu")
    with pytest.raises(ValueError, match="unknown fusion"):
        build_model(model_config("resnet", (16, 16, 3), fusion="blocked",
                                 **base), device="cpu")
    with pytest.raises(ValueError, match="fusion"):
        build_model(model_config("resnet", (16, 16, 3), norm="none",
                                 fusion="pallas_tail", **base),
                    device="cpu")
    with pytest.raises(ValueError, match="even"):
        build_model(model_config("resnet", (15, 15, 3),
                                 stem="space_to_depth", **base),
                    device="cpu")
    for family, shape in (("mlp", (4,)), ("convnet", (8, 8, 3))):
        model = build_model(model_config(family, shape, dropout_rate=0.1),
                            device="cpu")
        assert model.dropout_rate == 0.1
