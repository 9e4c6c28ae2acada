"""The port stands alone: no file of ``distkeras_tpu_torch`` (nor
``chip_smoke.py``) imports JAX, flax, msgpack, ml_dtypes or
``distkeras_tpu``; importing the package loads no JAX; entry points
default to CUDA and raise without a card instead of falling back to the
CPU."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from distkeras_tpu_torch import (ADAG, DecodeEngine, SingleTrainer,
                                 build_model, generate)
from distkeras_tpu_torch.models import model_config

# tiny shapes: one thread each keeps the parallel test workers off
# each other's cores
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "msgpack", "ml_dtypes",
             "distkeras_tpu")
SOURCES = sorted((ROOT / "distkeras_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
CFG = model_config("transformer_lm", (64,), input_dtype="int32",
                   vocab_size=16, num_layers=1, d_model=16, num_heads=2,
                   max_len=64, dtype="float32")


def _imported(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_jax_imports(path):
    assert not _imported(path) & set(FORBIDDEN), path


def test_import_loads_no_jax():
    code = ("import sys, distkeras_tpu_torch, distkeras_tpu_torch.convert, "
            "distkeras_tpu_torch.ops.fused_block, "
            "distkeras_tpu_torch.parallel.ring_attention, "
            "distkeras_tpu_torch.checkpoint, distkeras_tpu_torch.evaluators, "
            "distkeras_tpu_torch.ops.metrics, distkeras_tpu_torch.telemetry, "
            "distkeras_tpu_torch.flight_recorder, "
            "distkeras_tpu_torch.analysis.racecheck, "
            "distkeras_tpu_torch.parallel.transport, "
            "distkeras_tpu_torch.parallel.compression, "
            "distkeras_tpu_torch.parallel.host_ps, "
            "distkeras_tpu_torch.parallel.sharded_ps, "
            "distkeras_tpu_torch.parallel.faults, "
            "distkeras_tpu_torch.paging, distkeras_tpu_torch.speculative;"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]; print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("entry", ["build_model", "generate",
                                   "DecodeEngine", "SingleTrainer", "ADAG"])
def test_entry_points_raise_without_a_card(entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    call = {"build_model": lambda: build_model(CFG),
            "generate": lambda: generate(CFG, [[1, 2]], max_new_tokens=1),
            "DecodeEngine": lambda: DecodeEngine(CFG),
            "SingleTrainer": lambda: SingleTrainer(CFG),
            "ADAG": lambda: ADAG(CFG)}[entry]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()


def test_explicit_cpu_runs():
    out = generate(CFG, [[1, 2, 3]], max_new_tokens=2, device="cpu")
    assert out.shape == (1, 5) and out.device.type == "cpu"
