"""Data of the port, copies of ``distkeras_tpu/data`` (numpy and the
native columnar library only): the in-memory ``Dataset`` with its CSV
and npz readers, the out-of-core ``ShardedDataset``/``CsvShardedDataset``,
the ETL transformers and the synthetic generators."""

from distkeras_tpu_torch.data.dataset import Dataset  # noqa: F401
from distkeras_tpu_torch.data.sharded import (  # noqa: F401
    CsvShardedDataset,
    ShardedDataset,
)
from distkeras_tpu_torch.data.transformers import (  # noqa: F401
    AssembleTransformer,
    DenseTransformer,
    HashBucketTransformer,
    LabelIndexTransformer,
    MinMaxTransformer,
    OneHotTransformer,
    Pipeline,
    ReshapeTransformer,
    StandardScaleTransformer,
    Transformer,
)
from distkeras_tpu_torch.data import datasets  # noqa: F401
