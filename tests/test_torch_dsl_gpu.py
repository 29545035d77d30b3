"""The stencil toolchain's matrices through the generated kernels on a card.

Path M of ``chip_smoke.py`` as tests: every corpus program at
``block=(4, 4)`` and opt levels 0, 3 and 1 or 2 (M1, within 1e-12), and
every case of ``tests/torch_stencil_cases.py`` at opt level 0 and the
default (M2, within 1e-13), each launched once on card-layout storages and
held against the port's ``debug`` backend at ``opt_level=0``.  The domains
are small and the block is (4, 4), so tile boundaries fall inside them.  A
failed build or launch fails the test.

Needs a GPU and nvcc; skipped elsewhere.  This file imports neither JAX nor
the reference package:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_dsl_gpu.py
"""

import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch", reason="the torch port's tests need PyTorch")

import torch_stencil_cases as cases  # noqa: E402

pytestmark = pytest.mark.gpu

ROOT = Path(__file__).resolve().parents[1]
CORPUS_DIR = ROOT / "tests" / "corpus"
CORPUS = sorted(p.stem for p in CORPUS_DIR.glob("prog_*.json"))


@pytest.fixture(scope="module")
def built():
    """Every run of both matrices, its kernel compiled (``chip_smoke.build_all``: each source once, in parallel)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the generated kernels run only on the card")
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from chip_smoke import build_all

    corpus, rejected, expected = cases.corpus_runs(CORPUS_DIR)
    runs = corpus + cases.case_runs()
    build_all([r.stencil.kernel for r in runs])
    return {r.label: r for r in runs}, rejected, expected


def test_corpus_rejections_are_the_references(built):
    _runs, rejected, expected = built
    assert rejected == expected


@pytest.mark.parametrize("program", CORPUS)
def test_corpus_program_on_the_card(built, program):
    runs, rejected, _expected = built
    if program in rejected:
        return  # the reference's Pallas limit; test_corpus_rejections_are_the_references
    labels = [lab for lab in runs if lab.split("@")[0] == program]
    assert len(labels) == 3
    for lab in labels:
        cases.hold(runs[lab], torch.device("cuda"))


@pytest.mark.parametrize("case", [c.name for c in cases.CASES])
def test_case_on_the_card(built, case):
    runs, _rejected, _expected = built
    for lvl in ("0", "default"):
        cases.hold(runs[f"{case}@{lvl}"], torch.device("cuda"))
