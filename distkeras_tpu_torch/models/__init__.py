"""Models of the port: the config registry, ``TransformerLM`` and
generation, the MLP, the ConvNet, the ResNet family, Wide & Deep and the
BiLSTM classifier."""

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
from distkeras_tpu_torch.models.lstm import BiLSTMClassifier  # noqa: F401
from distkeras_tpu_torch.models.widedeep import WideAndDeep  # noqa: F401
