"""Model registry + config (de)serialization, the port's copy of
``distkeras_tpu/models/core.py``: the same config dicts, so a JSON
config written by either package builds in both."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping

from distkeras_tpu_torch.device import resolve_device

MODEL_REGISTRY: dict[str, Callable[..., Any]] = {}


def register_model(family: str):
    """Class decorator: register an ``nn.Module`` under ``family``."""

    def wrap(cls):
        MODEL_REGISTRY[family] = cls
        cls.family = family
        return cls

    return wrap


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """A serializable model description: family + constructor kwargs +
    an example input shape (without the batch dim)."""

    family: str
    kwargs: Mapping[str, Any]
    input_shape: tuple[int, ...]
    input_dtype: str = "float32"

    def to_config(self) -> dict:
        return {
            "family": self.family,
            "kwargs": dict(self.kwargs),
            "input_shape": list(self.input_shape),
            "input_dtype": self.input_dtype,
        }

    @staticmethod
    def from_config(config: Mapping[str, Any]) -> "ModelSpec":
        if "family" not in config:
            raise KeyError(
                "model config missing 'family' key; build configs with "
                "distkeras_tpu_torch.models.model_config")
        # JSON turns tuples into lists; normalize back
        kwargs = {k: tuple(v) if isinstance(v, list) else v
                  for k, v in config.get("kwargs", {}).items()}
        return ModelSpec(
            family=config["family"],
            kwargs=kwargs,
            input_shape=tuple(config["input_shape"]),
            input_dtype=config.get("input_dtype", "float32"),
        )

    def build(self, device=None):
        return build_model(self.to_config(), device=device)


def model_config(family: str, input_shape: tuple[int, ...],
                 input_dtype: str = "float32", **kwargs) -> dict:
    return ModelSpec(family, kwargs, tuple(input_shape),
                     input_dtype).to_config()


def build_model(config: Mapping[str, Any], device=None):
    """Config dict -> ``nn.Module`` on ``device`` (default ``cuda``;
    raises without a card unless ``device="cpu"``)."""
    dev = resolve_device(device)
    # the family table fills as the model modules import
    import distkeras_tpu_torch.models.convnet  # noqa: F401
    import distkeras_tpu_torch.models.lstm  # noqa: F401
    import distkeras_tpu_torch.models.mlp  # noqa: F401
    import distkeras_tpu_torch.models.resnet  # noqa: F401
    import distkeras_tpu_torch.models.transformer  # noqa: F401
    import distkeras_tpu_torch.models.widedeep  # noqa: F401

    family = config["family"]
    if family not in MODEL_REGISTRY:
        raise KeyError(
            f"unknown model family {family!r}; known: "
            f"{sorted(MODEL_REGISTRY)}")
    cls = MODEL_REGISTRY[family]
    kwargs = dict(config.get("kwargs", {}))
    # a torch layer is sized at construction: the families that read
    # their input's shape (flax infers it at init) take it from the config
    if getattr(cls, "takes_input_shape", False):
        kwargs["input_shape"] = tuple(config["input_shape"])
    return cls(**kwargs).to(dev)
