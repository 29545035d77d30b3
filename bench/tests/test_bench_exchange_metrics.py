"""CPU tests of the readers of the distributed step's split: the exchange's
wait and copies from ``rank_timings``, the bytes on the wire from the
``messages`` counter and the full scratch from ``rank_timings``, on
hand-made records, and nothing on a record without those keys (a program
that does not report them).  Run: ``python -m pytest -q bench/tests``."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench.metrics import exchange_copy_ms, exchange_mb_per_step, exchange_wait_ms, scratch_gb_per_step  # noqa: E402

STEPS = 20  # two traced calls of 10 steps


def _timings(scale, **extra):
    t = {"steps": 10, "exchange_seconds": 0.07 * scale, "pack_seconds": 0.01 * scale,
         "wait_seconds": 0.05 * scale, "steady_wait_seconds": 0.04 * scale,
         "unpack_seconds": 0.01 * scale, "pad_seconds": 0.002 * scale,
         "release_seconds": 0.001 * scale, "scratch_bytes": 5_000_000_000}
    t.update(extra)
    return t


def _rank(scale, messages=None, **extra):
    counters = {"messages": messages or {"exchanges": 40, "send": 80, "recv": 80,
                                         "send_bytes": 3_000_000, "recv_bytes": 2_000_000}}
    infos = [{"rank_timings": _timings(scale, **extra)} for _ in range(2)]
    return {"trace": {"steps": STEPS, "counters": counters, "exec_info": infos}}


def _ctx(*ranks):
    return {"spec": {"cell": "cosmo1e.x4"}, "ranks": list(ranks)}


def test_the_wait_and_the_copies_are_the_largest_rank_a_step():
    """The wait read is the steady one (``steady_wait_seconds``), not the
    whole (``wait_seconds``, its first exchange's skew included)."""
    ctx = _ctx(_rank(1.0), _rank(3.0), _rank(2.0))
    assert exchange_wait_ms.read(ctx) == pytest.approx(1e3 * 2 * 0.04 * 3.0 / STEPS)
    assert exchange_copy_ms.read(ctx) == pytest.approx(1e3 * 2 * (0.01 + 0.01 + 0.002 + 0.001) * 3.0 / STEPS)


def test_the_bytes_and_the_scratch_are_rank_zeros_a_step():
    ctx = _ctx(_rank(1.0), _rank(1.0, scratch_bytes=1))
    assert exchange_mb_per_step.read(ctx) == pytest.approx(5_000_000 / STEPS / 1e6)
    assert scratch_gb_per_step.read(ctx) == pytest.approx(2 * 5.0 / STEPS)


def _without(rank, keys):
    for info in rank["trace"]["exec_info"]:
        for k in keys:
            info["rank_timings"].pop(k)
    return rank


@pytest.mark.parametrize("reader,keys", [
    (exchange_wait_ms, ("steady_wait_seconds",)),
    (exchange_copy_ms, ("pack_seconds", "unpack_seconds", "pad_seconds", "release_seconds")),
    (scratch_gb_per_step, ("scratch_bytes",)),
])
def test_a_record_without_the_timings_reads_nothing(reader, keys):
    assert reader.read(_ctx(_without(_rank(1.0), keys), _rank(1.0))) is None
    if reader is not scratch_gb_per_step:  # the largest over the ranks needs every rank's timing
        assert reader.read(_ctx(_rank(1.0), {"trace": {}})) is None
    assert reader.read(_ctx({})) is None


def test_a_counter_without_bytes_or_exchanges_reads_nothing():
    old = {"exchanges": 40, "send": 80, "recv": 80}
    assert exchange_mb_per_step.read(_ctx(_rank(1.0, messages=old))) is None
    none_ran = {"exchanges": 0, "send": 0, "recv": 0, "send_bytes": 0, "recv_bytes": 0}
    assert exchange_mb_per_step.read(_ctx(_rank(1.0, messages=none_ran))) is None
    assert exchange_mb_per_step.read(_ctx({})) is None
