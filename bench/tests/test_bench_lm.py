"""CPU tests of the LM decode cell (``moonlight.decode7k``): a rehearsal at
a small size reads ``correct: true``, and ``correct: false`` with the
check's control or any planted fault (``lm_faults.py``, each in a process of
its own, since a fault patches the program for the rest of its process);
each per-layer reader on hand-made records, and nothing where a record has
nothing to read (a program without the device probe); the count.  Run:
``python -m pytest -q bench/tests``."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench import count_lm  # noqa: E402
from bench.metrics import (  # noqa: E402
    expert_roofline, experts_touched_per_step, latent_attend_roofline, latent_cache_gb_per_step, lm_step_mfu)
from bench.tests.lm_faults import FAULTS  # noqa: E402

CELL = "moonlight.decode7k"


def _config():
    return json.loads((ROOT / "bench" / "configs" / "moonlight.json").read_text())


def _rehearse(fault=None):
    cmd = [sys.executable, str(ROOT / "bench" / "tests" / "lm_rehearse.py"), CELL] + ([fault] if fault else [])
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_sound_rehearsal_is_correct_and_loads_no_jax():
    out = _rehearse()
    assert out["correct"] is True and out["failed"] == 0, out["checks"]
    assert out["banned"] == []
    assert out["state"]["first_equals_final"] is True
    assert 0.0 <= out["checks"]["replayed_share"]["value"] < 1.0


@pytest.mark.parametrize("fault", ("control",) + FAULTS)
def test_the_control_and_each_fault_are_not_correct(fault):
    out = _rehearse(fault)
    assert out["correct"] is False and out["failed"] >= 1, out["checks"]


# the readers, on a hand-made record of 48 traced steps


STEPS = 48


def _ctx(lm=None, window_s=0.5, steps=25 * 16):
    trace = {"steps": STEPS, "counters": {"lm": lm} if lm is not None else {}}
    spec = {"cell": CELL, "cfg": _config(), "traffic": {"steps_per_call": 16}}
    return {"spec": spec, "ranks": [{"window_s": window_s, "steps": steps, "trace": trace}]}


def _probe(touched=63.9):
    calls = 26 * STEPS
    per_expert = count_lm.expert_bytes(_config())
    return {"clock": "cuda_events",
            "seconds": {"mla.attend": STEPS * 0.010, "moe.experts": STEPS * 0.0125, "lm.decode_step": STEPS * 0.02},
            "calls": {"mla.attend": 27 * STEPS, "moe.experts": calls},
            "counts": {"mla.latent_bytes": STEPS * 27_012_759_552, "mla.decode_calls": 27 * STEPS,
                       "moe.layer_calls": calls, "moe.experts_touched": touched * calls,
                       "moe.expert_bytes": touched * calls * per_expert, "moe.expert_tokens": [6 * STEPS] * 64}}


def test_the_readers_on_a_record():
    cfg = _config()
    ctx = _ctx(_probe())
    assert latent_cache_gb_per_step.read(ctx) == pytest.approx(27.012759552, rel=1e-12)
    assert experts_touched_per_step.read(ctx) == pytest.approx(63.9, rel=1e-12)
    need = 64 * 7176.5 * 27 * 1152
    assert count_lm.latent_bytes(cfg, 16) == pytest.approx(need, rel=1e-15) == pytest.approx(14.285942784e9)
    assert latent_attend_roofline.read(ctx) == pytest.approx(100 * need / 3.35e12 / 0.010, rel=1e-12)
    touched_bytes = 63.9 * 26 * count_lm.expert_bytes(cfg)
    assert expert_roofline.read(ctx) == pytest.approx(100 * touched_bytes / 3.35e12 / 0.0125, rel=1e-12)
    least = count_lm.least_seconds(cfg, 16, touched_bytes)
    assert least["bound"] == "bytes"
    assert lm_step_mfu.read(ctx) == pytest.approx(100 * least["seconds"] / (0.5 / 400), rel=1e-12)


@pytest.mark.parametrize("reader", [lm_step_mfu, latent_attend_roofline, expert_roofline, latent_cache_gb_per_step,
                                    experts_touched_per_step])
def test_a_reader_finds_nothing_without_the_probe(reader):
    assert reader.read(_ctx(None)) is None
    assert reader.read({"spec": _ctx()["spec"], "ranks": [{"window_s": 1.0, "steps": 16}]}) is None


def test_the_count_at_the_published_config():
    cfg = _config()
    assert count_lm.expert_bytes(cfg) == 3 * 2048 * 1408 * 2
    # the weights a step reads: 64 experts in 26 layers, every expert touched, and the rest
    total = 26 * 64 * count_lm.expert_bytes(cfg) + count_lm.other_weight_bytes(cfg)
    assert 31.2e9 < total < 31.3e9
    assert 0.75e12 < count_lm.decode_flops(cfg, 16) < 0.77e12
    least = count_lm.least_seconds(cfg, 16, 26 * 64 * count_lm.expert_bytes(cfg))
    assert least["bound"] == "bytes" and 0.0135 < least["seconds"] < 0.0137
