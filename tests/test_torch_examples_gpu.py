"""The port's examples on a CUDA card, at their default device: quickstart's
four backends agree and its ``cuda`` backend launches ``smooth`` once; the
climate model's program launches two kernels a step and its eager driver
five, within 1e-10 of each other.

Needs a GPU and nvcc; skipped elsewhere.  This file imports neither JAX nor
the reference package:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_examples_gpu.py
"""

import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch", reason="the torch port's tests need PyTorch")

from repro_torch.core import codegen_cuda  # noqa: E402

pytestmark = pytest.mark.gpu

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the examples' default device is the card")
    return torch.device("cuda")


def _load(name: str):
    spec = importlib.util.spec_from_file_location(f"{name}_gpu", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_runs_on_the_card_by_default(card):
    codegen_cuda.reset_launch_counts()
    out = _load("quickstart_torch").main([])
    assert out["device"].startswith("cuda")
    assert sum(codegen_cuda.launch_counts().values()) == 1


def test_climate_model_runs_on_the_card_by_default(card):
    out = _load("climate_model_torch").main(["--nx", "40", "--ny", "70", "--nz", "8", "--nt", "3", "--compare"])
    assert out["device"].startswith("cuda")
    assert out["program"]["launches_per_step"] == 2 and out["eager"]["launches_per_step"] == 5
    assert out["max_deviation"] <= 1e-10
