"""distkeras_tpu_torch: the PyTorch/CUDA port of distkeras_tpu.

On an NVIDIA H100: ``SingleTrainer`` and ``SyncTrainer`` train
``TransformerLM`` and the MLP, ConvNet and ResNet, ``DecodeEngine``
serves the LM (int8 KV, the prefix store, chunked prefill, paged KV
with its QoS, speculative decoding, hot weight swaps and the KV-block
handoff of ``serving.pack_kv_blocks``), the parameter-server family
(``DOWNPOUR``, ``ADAG``, ``DynSGD``, ``AEASGD``, ``EAMSGD``) trains
through the emulated commit rounds, and
``EnsembleTrainer``/``AveragingTrainer`` train members on disjoint
shards.  The trainers checkpoint and resume in the JAX
package's file format (``checkpoint.py``), either package reading the
other's files, and ``predictors.ModelPredictor`` and ``evaluators``
score a ``Dataset``.  Every trainer also streams out-of-core npz and
CSV shards (``data.ShardedDataset``), through the ETL transformers on
the native columnar library (``native``), which feed the Wide & Deep
and BiLSTM families.  Attention, GroupNorm and the fused ResNet
bottleneck run hand-written CUDA kernels, forward and backward
(``ops/attention.py``, ``ops/group_norm.py``, ``ops/fused_block.py``,
``csrc/``).  Entry points run on ``cuda`` unless
the caller passes ``device="cpu"``, and raise when no card is present.
The package imports neither JAX nor ``distkeras_tpu``.
"""

from distkeras_tpu_torch.data import Dataset  # noqa: F401
from distkeras_tpu_torch.models import (  # noqa: F401
    ModelSpec, TransformerLM, build_model, generate, model_config)
from distkeras_tpu_torch.serving import DecodeEngine, ShedError  # noqa: F401
from distkeras_tpu_torch.trainers import (  # noqa: F401
    ADAG, AEASGD, DOWNPOUR, EAMSGD, AveragingTrainer, DistributedTrainer,
    DynSGD, EnsembleTrainer, SingleTrainer, SyncTrainer, Trainer)
