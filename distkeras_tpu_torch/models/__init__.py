"""Models of the port: the config registry, ``TransformerLM`` and
generation, the MLP, the ConvNet and the ResNet family."""

from distkeras_tpu_torch.models.core import (  # noqa: F401
    MODEL_REGISTRY, ModelSpec, build_model, model_config, register_model)
from distkeras_tpu_torch.models.generate import (  # noqa: F401
    decode_step, generate)
from distkeras_tpu_torch.models.transformer import (  # noqa: F401
    KVCache, TransformerLM, dense_causal_attention)
from distkeras_tpu_torch.models.convnet import ConvNet  # noqa: F401
from distkeras_tpu_torch.models.mlp import MLP  # noqa: F401
from distkeras_tpu_torch.models.resnet import (  # noqa: F401
    ResNet, ResNet18, ResNet50)
