"""Data of the port: the in-memory ``Dataset`` and the synthetic
generators, copies of ``distkeras_tpu/data`` (numpy only)."""

from distkeras_tpu_torch.data.dataset import Dataset  # noqa: F401
