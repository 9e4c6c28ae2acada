"""Batch inference, the port of ``distkeras_tpu/predictors.py``:
``ModelPredictor.predict(dataset)`` runs the model over the feature
column in eval mode and returns the ``Dataset`` with a prediction column
appended (DataFrame in, DataFrame out).

The forward runs in eval mode (``train=False``: no dropout, BatchNorm
on its running statistics) on the caller's device (default ``cuda``;
the model's own device for a built module), one batch at a time, with
the dataset's ragged tail padded to a full batch, so every call has one
shape, and the padding stripped afterwards.  The predictions stay on the device
until the last batch and come to the host in one copy.  A bf16 model's
outputs come back as f32 (exact: numpy has no bf16).

The reference shards the batch over a device mesh (``num_shards``) and
its parameters over a model axis (``model_parallel``, ``tp_rules``);
those arms raise (ROADMAP.md §1 item 9), as do multi-output models,
which only Keras-ingested DAGs produce (item 10).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch.func import functional_call

from distkeras_tpu_torch.data.dataset import Dataset
from distkeras_tpu_torch.models.core import ModelSpec
from distkeras_tpu_torch.utils import pad_to_multiple


def _unsupported(what: str, item: int):
    return NotImplementedError(
        f"{what} is not ported to distkeras_tpu_torch yet (ROADMAP.md §1 "
        f"item {item})")


def _multi_output(spec: ModelSpec | None) -> bool:
    return spec is not None and len(spec.kwargs.get("outputs", ())) > 1


class ModelPredictor:
    """Append a prediction column: ``output="logits"``, ``"prob"``
    (softmax) or ``"class"`` (argmax, int32).  ``model``: a
    ``ModelSpec``, a model config dict (built on ``device``) or a built
    ``nn.Module``; ``variables``: its ``state_dict`` (any dtype; the
    trainers' f32 masters are cast to the module's dtypes), which may be
    replaced between calls (``predictor.variables = ...``)."""

    def __init__(self, model, variables: Mapping, *,
                 features_col: str = "features",
                 output_col: str = "prediction", output: str = "logits",
                 batch_size: int = 512, num_shards: int | None = None,
                 model_parallel: int = 1, tp_rules=None, device=None):
        if isinstance(model, ModelSpec):
            self.spec = model
        elif isinstance(model, Mapping):
            self.spec = ModelSpec.from_config(model)  # raises if malformed
        elif isinstance(model, torch.nn.Module):
            self.spec = None
        else:
            raise TypeError(
                "model must be a ModelSpec, a model config dict, or a "
                f"torch module; got {type(model).__name__}")
        if output not in ("logits", "prob", "class"):
            raise ValueError(f"unknown output {output!r}")
        if int(model_parallel) < 1:
            raise ValueError(
                f"model_parallel must be >= 1, got {model_parallel}")
        if tp_rules is not None and int(model_parallel) == 1:
            raise ValueError(
                "tp_rules given but model_parallel=1 — pass "
                "model_parallel>1 to shard parameters")
        if int(model_parallel) > 1 or tp_rules is not None:
            raise _unsupported("model_parallel > 1 / tp_rules", 9)
        if (num_shards or 1) > 1:
            raise _unsupported("num_shards > 1 (a mesh of devices)", 9)
        if _multi_output(self.spec):
            raise _unsupported("multi-output models", 10)
        self.model = (self.spec.build(device=device) if self.spec is not None
                      else model)
        own = dict(self.model.named_parameters())
        own.update(self.model.named_buffers())
        self._own = own
        self.variables = variables
        self.features_col = features_col
        self.output_col = output_col
        self.output = output
        self.batch_size = int(batch_size)

    @property
    def variables(self) -> dict:
        return self._variables

    @variables.setter
    def variables(self, variables: Mapping) -> None:
        # each value in its own tensor's dtype, on the model's device
        self._variables = {
            k: torch.as_tensor(v).detach().to(device=self._own[k].device,
                                              dtype=self._own[k].dtype)
            for k, v in variables.items()}

    @torch.no_grad()
    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        out = functional_call(self.model, self._variables, (x,),
                              {"train": False})
        if isinstance(out, (tuple, list)):
            raise _unsupported("multi-output models", 10)
        if self.output == "class":
            return torch.argmax(out, dim=-1).int()
        out = out.float()
        return torch.softmax(out, dim=-1) if self.output == "prob" else out

    def predict(self, dataset: Dataset) -> Dataset:
        n = len(dataset)
        x = pad_to_multiple(np.asarray(dataset[self.features_col]),
                            self.batch_size, axis=0)
        device = next(iter(self._own.values())).device
        outs = [self._forward(torch.from_numpy(
                    x[lo:lo + self.batch_size]).to(device))
                for lo in range(0, len(x), self.batch_size)]
        pred = torch.cat(outs).cpu().numpy()[:n]
        return dataset.with_column(self.output_col, pred)

    def __call__(self, dataset: Dataset) -> Dataset:
        return self.predict(dataset)
