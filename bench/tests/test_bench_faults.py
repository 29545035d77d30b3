"""A run with the timed path broken underneath comes out not correct: each
fault a cell can have, and the check's control (the float32 reference in
the program's place), planted in the program (``faults.py``), on the CPU at
a small size (``rehearse.py``, in a process of its own, since a fault
patches the program for the rest of its process), the harness unchanged
above it."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


def _rehearse(cell, fault=None):
    cmd = [sys.executable, str(ROOT / "bench" / "tests" / "rehearse.py"), cell] + ([fault] if fault else [])
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])

CASES = [(cell, fault) for cell in ("cosmo1.program", "cosmo1.eager")
         for fault in ("unchanged", "altered", "control")]
CASES += [("cosmoe.ensemble", f) for f in ("unchanged", "altered", "half_members", "control")]
CASES += [("cosmo1e.x4", f) for f in ("unchanged", "altered", "half_members", "no_exchange", "control")]


@pytest.mark.parametrize("cell", ["cosmo1.program", "cosmo1.eager", "cosmoe.ensemble", "cosmo1e.x4"])
def test_a_sound_run_is_correct(cell):
    out = _rehearse(cell)
    assert out["correct"] is True and out["failed"] == 0, out["checks"]


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_planted_fault_is_not_correct(cell, fault):
    out = _rehearse(cell, fault)
    assert out["correct"] is False and out["failed"] >= 1, out["checks"]
