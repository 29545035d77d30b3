"""Serving subsystem contract tests (repro.serving), engine level — no
websocket dependency.

THE contract: serving K concurrent requests through one dynamically-batched
vmapped dispatch is BIT-identical (float64) to K sequential per-request
program runs — the PR-4 vmap-vs-loop oracle, re-aimed at the request path.
Plus: the member scatter/gather helpers, admission-control error codes,
batching-window/padding behavior, and the segment plan."""

import asyncio
import json

import numpy as np
import torch
import pytest

from repro_torch.core import caching
from repro_torch.core.storage import Storage
from repro_torch.ensemble import EnsembleError, batch
from repro_torch.serving import RequestSpec, ServingEngine, ServingError, drive_engine
from repro_torch.serving.engine import _segment_plan, tuned_member_counts
from repro_torch.stencils.forecast import (
    DEFAULT_SCALARS,
    FIELD_NAMES,
    build_forecast_step,
    make_forecast_fields,
    request_state,
)

DOM = (12, 10, 5)


@pytest.fixture(scope="module")
def step():
    return build_forecast_step("torch", DOM, name="serve_step")


@pytest.fixture(scope="module")
def templates():
    return make_forecast_fields("torch", DOM, device="cpu")


@pytest.fixture()
def engine(step, templates):
    fields, scalars = templates
    eng = ServingEngine(window_ms=25.0)
    eng.register(
        step,
        fields=fields,
        scalars=scalars,
        request_fields=("phi",),
        member_counts=(1, 2, 4),
        max_steps=100,
    )
    return eng


def sequential(step, templates, phi0, steps, scalars=None):
    """The oracle: per-request CompiledProgram calls in a Python loop."""
    fields, default_scalars = templates
    f = {
        n: Storage(s.data.clone(), backend="torch", default_origin=s.default_origin, axes=s.axes)
        for n, s in fields.items()
    }
    f["phi"].data = torch.from_numpy(np.array(phi0, copy=True))
    sc = dict(default_scalars)
    sc.update(scalars or {})
    for _ in range(steps):
        step(*[f[n] for n in FIELD_NAMES], **sc)
    return f["phi"].to_numpy()


def drive(engine, specs, **kw):
    async def go():
        async with engine:
            return await drive_engine(engine, specs, **kw)

    return asyncio.run(go())


# ---------------------------------------------------------------------------
# bit-identity: batched serving == sequential per-request execution
# ---------------------------------------------------------------------------


def test_single_request_bit_identical(step, templates, engine):
    phi0 = request_state(DOM, seed=1)
    rep = drive(engine, [RequestSpec("serve_step", {"phi": phi0}, steps=3)])
    (res,) = rep.results
    assert res.steps_seen == [1, 2, 3] and res.in_order
    for t in (1, 2, 3):
        ref = sequential(step, templates, phi0, t)
        assert np.abs(res.step_fields[t]["phi"] - ref).max() == 0.0


def test_dispatch_labels_a_profile_with_its_program(engine):
    """Under torch.profiler a dispatch is a range named for the program it
    runs, whatever the tracer's state; the span itself stays
    ``serving.dispatch``."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        drive(engine, [RequestSpec("serve_step", {"phi": request_state(DOM, seed=2)}, steps=2)])
    assert "serving.dispatch[serve_step]" in {e.name for e in prof.events()}


def test_concurrent_requests_bit_identical_to_sequential(step, templates, engine):
    """Three requests ride ONE padded 4-member batch; every streamed state
    matches its own sequential run to 0 ULP."""
    specs = [
        RequestSpec("serve_step", {"phi": request_state(DOM, seed=i + 1)}, steps=4, stream_every=2)
        for i in range(3)
    ]
    rep = drive(engine, specs)
    assert rep.all_in_order
    for spec, res in zip(specs, rep.results):
        assert res.steps_seen == [2, 4]
        assert res.members == 4 and res.occupancy == pytest.approx(3 / 4)
        for t in (2, 4):
            ref = sequential(step, templates, spec.fields["phi"], t)
            assert np.abs(res.step_fields[t]["phi"] - ref).max() == 0.0
    assert engine.stats()["batches"] == 1  # one window, one batch


def test_mixed_horizons_and_cadences(step, templates, engine):
    """Requests with different steps/stream_every share a batch: the segment
    plan must emit each request exactly at its own cadence."""
    specs = [
        RequestSpec("serve_step", {"phi": request_state(DOM, seed=1)}, steps=5, stream_every=2),
        RequestSpec("serve_step", {"phi": request_state(DOM, seed=2)}, steps=3, stream_every=1),
        RequestSpec("serve_step", {"phi": request_state(DOM, seed=3)}, steps=2, stream_every=5),
    ]
    rep = drive(engine, specs)
    assert [r.steps_seen for r in rep.results] == [[2, 4, 5], [1, 2, 3], [2]]
    for spec, res in zip(specs, rep.results):
        for t in res.steps_seen:
            ref = sequential(step, templates, spec.fields["phi"], t)
            assert np.abs(res.step_fields[t]["phi"] - ref).max() == 0.0


def test_per_request_scalars_ride_member_axis(step, templates, engine):
    """Different per-request dt values become ONE per-member scalar array —
    each request still matches its own sequential run exactly."""
    dts = [0.05, 0.1, 0.2]
    specs = [
        RequestSpec("serve_step", {"phi": request_state(DOM, seed=7)}, scalars={"dt": dt}, steps=3)
        for dt in dts
    ]
    rep = drive(engine, specs)
    assert engine.stats()["batches"] == 1
    for dt, res in zip(dts, rep.results):
        ref = sequential(step, templates, request_state(DOM, seed=7), 3, scalars={"dt": dt})
        assert np.abs(res.final_fields["phi"] - ref).max() == 0.0


def test_shared_templates_survive_serving(templates, engine):
    """Shared read-only fields are handed to the batch as the registered
    template storages — serving must never write them back N-replicated."""
    fields, _ = templates
    u_before = fields["u"].to_numpy().copy()
    drive(engine, [RequestSpec("serve_step", {"phi": request_state(DOM, seed=1)}, steps=2)])
    assert fields["u"].shape == u_before.shape
    np.testing.assert_array_equal(fields["u"].to_numpy(), u_before)


def test_load_generator_smoke(step, templates, engine):
    """N concurrent simulated clients: ordered streams, full report, and
    bit-identical final states."""
    n = 5
    specs = [
        RequestSpec("serve_step", {"phi": request_state(DOM, seed=i + 1)}, steps=4, stream_every=2)
        for i in range(n)
    ]
    rep = drive(engine, specs, keep_fields="final")
    assert rep.requests == n and rep.all_in_order
    assert rep.requests_per_second > 0 and rep.p99_ms >= rep.p50_ms > 0
    assert 0 < rep.mean_occupancy <= 1
    for spec, res in zip(specs, rep.results):
        ref = sequential(step, templates, spec.fields["phi"], 4)
        assert np.abs(res.final_fields["phi"] - ref).max() == 0.0
    st = engine.stats()
    assert st["requests"] == n and st["steps_streamed"] == 2 * n


# ---------------------------------------------------------------------------
# admission control: reject at the door, never recompile-stall
# ---------------------------------------------------------------------------


def expect_code(code, fn, *args, **kw):
    with pytest.raises(ServingError) as ei:
        fn(*args, **kw)
    assert ei.value.code == code, ei.value


def test_admission_error_codes(engine):
    phi0 = request_state(DOM, seed=1)
    expect_code(404, engine.admit, "nope", {"phi": phi0})
    expect_code(409, engine.admit, "serve_step", {"phi": phi0}, fingerprint="deadbeef")
    expect_code(413, engine.admit, "serve_step", {"phi": phi0[:-1]})  # wrong shape
    expect_code(413, engine.admit, "serve_step", {"phi": phi0.astype(np.float32)})
    expect_code(413, engine.admit, "serve_step", {})  # missing field
    expect_code(413, engine.admit, "serve_step", {"phi": phi0, "u": phi0})  # unexpected
    expect_code(422, engine.admit, "serve_step", {"phi": phi0}, {"bogus": 1.0})
    expect_code(422, engine.admit, "serve_step", {"phi": phi0}, {"dt": np.ones(3)})
    expect_code(422, engine.admit, "serve_step", {"phi": phi0}, steps=0)
    expect_code(422, engine.admit, "serve_step", {"phi": phi0}, steps=101)  # > max_steps
    expect_code(422, engine.admit, "serve_step", {"phi": phi0}, stream_every=0)


def test_good_fingerprint_admitted(engine):
    entry = engine.catalog()[0]
    req = engine.admit("serve_step", {"phi": request_state(DOM, seed=1)}, fingerprint=entry["fingerprint"])
    assert req.entry.fingerprint == entry["fingerprint"]


def test_numpy_backend_rejected_at_registration():
    eng = ServingEngine()
    fields, scalars = make_forecast_fields("numpy", DOM)
    step_np = build_forecast_step("numpy", DOM, name="np_serve")
    expect_code(
        500, eng.register, step_np, fields=fields, scalars=scalars, request_fields=("phi",)
    )


# ---------------------------------------------------------------------------
# batching mechanics: scatter/gather, padding, segment plan, tuned counts
# ---------------------------------------------------------------------------


def test_scatter_members_pads_with_last_request(templates):
    fields, _ = templates
    tmpl = fields["phi"]
    a, b = request_state(DOM, seed=1), request_state(DOM, seed=2)
    batched = batch.scatter_members([a, b], 4, template=tmpl)
    assert batched.is_member_batched and batched.members == 4
    assert batched.axes == ("N",) + tmpl.axes
    assert batched.default_origin == (0,) + tmpl.default_origin
    raw = batched.to_numpy()
    np.testing.assert_array_equal(raw[0], a)
    np.testing.assert_array_equal(raw[1], b)
    np.testing.assert_array_equal(raw[2], b)  # padding repeats the last request
    np.testing.assert_array_equal(raw[3], b)


def test_gather_member_round_trips_and_copies(templates):
    fields, _ = templates
    tmpl = fields["phi"]
    arrays = [request_state(DOM, seed=i) for i in range(3)]
    batched = batch.scatter_members(arrays, 3, template=tmpl)
    for i, a in enumerate(arrays):
        got = batch.gather_member(batched, i)
        np.testing.assert_array_equal(got, a)
        got[0, 0, 0] = 1e9  # host copy: mutating the gather must not leak back
    np.testing.assert_array_equal(batch.gather_member(batched, 0), arrays[0])


def test_scatter_members_errors(templates):
    fields, _ = templates
    tmpl = fields["phi"]
    good = request_state(DOM, seed=0)
    with pytest.raises(EnsembleError, match="at least one"):
        batch.scatter_members([], 2, template=tmpl)
    with pytest.raises(EnsembleError, match="member slots"):
        batch.scatter_members([good] * 3, 2, template=tmpl)
    with pytest.raises(EnsembleError, match="shape"):
        batch.scatter_members([good[:-1]], 2, template=tmpl)
    with pytest.raises(EnsembleError, match="member axis"):
        batch.gather_member(tmpl, 0)


def test_segment_plan_unions_stream_points(engine):
    reqs = [
        engine.admit("serve_step", {"phi": request_state(DOM, seed=1)}, steps=5, stream_every=2),
        engine.admit("serve_step", {"phi": request_state(DOM, seed=2)}, steps=3, stream_every=1),
    ]
    # points: {2, 4, 5} ∪ {1, 2, 3} → segments 1,1,1,1,1 — and for a lone
    # coarse request the plan collapses to few long fused dispatches
    assert _segment_plan(reqs) == [1, 1, 1, 1, 1]
    lone = engine.admit("serve_step", {"phi": request_state(DOM, seed=1)}, steps=10, stream_every=4)
    assert _segment_plan([lone]) == [4, 4, 2]


def test_padding_picks_nearest_member_count(engine):
    entry = next(iter(engine._programs.values()))
    assert entry.member_counts == (1, 2, 4)
    assert [entry.pad_to(k) for k in (1, 2, 3, 4)] == [1, 2, 4, 4]
    assert entry.pad_to(9) == 4  # oversized batches split at max_batch


def test_tuned_member_counts_read_autotune_store(step, templates):
    fields, scalars = templates
    cp = step.compiled(fields, scalars)
    obj = cp.group_objects[0]
    path = caching.tuning_path(obj.name, obj.fingerprint)
    # serving engines in earlier tests may have written observed-batch records
    # (the write-back loop is on by default); start from a clean store
    path.unlink(missing_ok=True)
    # no store on disk → no tuned counts → registration falls back to defaults
    assert tuned_member_counts(cp) == []
    try:
        path.write_text(json.dumps({"version": 1, "domains": {"k": {"block": [8, 8], "batch": 6}}}))
        assert tuned_member_counts(cp) == [6]
        eng = ServingEngine()
        entry = eng.register(step, fields=fields, scalars=scalars, request_fields=("phi",))
        assert 6 in entry.member_counts  # tuned count joins the padding targets
    finally:
        path.unlink(missing_ok=True)


def test_warm_prejits_every_member_count(step, templates):
    fields, scalars = templates
    eng = ServingEngine(window_ms=25.0)
    eng.register(
        step,
        fields=fields,
        scalars=scalars,
        request_fields=("phi",),
        member_counts=(1, 2),
        warm=True,
        warm_chunk=1,
    )
    spec = RequestSpec("serve_step", {"phi": request_state(DOM, seed=3)}, steps=1)
    rep = drive(eng, [spec])
    assert rep.results[0].members == 1  # lone request pads to the count of 1


# ---------------------------------------------------------------------------
# the port against the reference; the entry points' devices
# ---------------------------------------------------------------------------


def test_streams_agree_with_the_reference_engine(step, templates):
    """The same three requests through the reference's engine (jax backend)
    and the port's (torch backend, CPU): every streamed field within 1e-12."""
    import repro  # noqa: F401  (the reference turns on float64 for jax)
    from repro.serving import RequestSpec as RefSpec
    from repro.serving import ServingEngine as RefEngine
    from repro.serving import drive_engine as ref_drive
    from repro.stencils.forecast import build_forecast_step as ref_step
    from repro.stencils.forecast import make_forecast_fields as ref_fields

    ref_eng = RefEngine(window_ms=25.0)
    rf, rs = ref_fields("jax", DOM)
    ref_eng.register(ref_step("jax", DOM, name="serve_step"), fields=rf, scalars=rs, request_fields=("phi",),
                     member_counts=(1, 2, 4), max_steps=100)
    phis = [request_state(DOM, seed=i + 1) for i in range(3)]
    cadence = [(4, 2), (3, 1), (4, 4)]

    async def ref_go():
        async with ref_eng:
            return await ref_drive(ref_eng, [RefSpec("serve_step", {"phi": p}, steps=s, stream_every=e)
                                             for p, (s, e) in zip(phis, cadence)])

    ref = asyncio.run(ref_go())
    fields, scalars = templates
    eng = ServingEngine(window_ms=25.0)
    eng.register(step, fields=fields, scalars=scalars, request_fields=("phi",), member_counts=(1, 2, 4),
                 max_steps=100)
    got = drive(eng, [RequestSpec("serve_step", {"phi": p}, steps=s, stream_every=e)
                      for p, (s, e) in zip(phis, cadence)])
    worst = 0.0
    for a, b in zip(got.results, ref.results):
        assert a.ok and b.ok and a.steps_seen == b.steps_seen and a.steps_seen
        for t in a.steps_seen:
            worst = max(worst, float(np.abs(a.step_fields[t]["phi"] - b.step_fields[t]["phi"]).max()))
    assert worst <= 1e-12


def test_serve_cli_load_test_on_the_named_device():
    """``python -m repro_torch.launch.serve --load N`` in process, on the
    device it is given (here the CPU: the cuda backend runs its plain
    modules on CPU tensors)."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--load", "3", "--steps", "2", "--stream-every", "1",
         "--domain", "8", "6", "4", "--device", "cpu", "--no-slo"],
        capture_output=True, text=True, timeout=180, cwd=str(root),
        env={**os.environ, "PYTHONPATH": str(root / "src")},
    )
    assert out.returncode == 0, out.stderr
    assert "3 concurrent requests x 2 steps" in out.stdout and "device cpu" in out.stdout
    assert "in order: True" in out.stdout


def test_registered_templates_default_to_the_card():
    """The serving entry point takes its device from the template storages,
    which the card holds unless the caller names a device: without a card
    the default refuses instead of serving from host memory."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a card: tests/test_torch_serving_gpu.py covers the default there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_forecast_fields("cuda", DOM)
    fields, _ = make_forecast_fields("cuda", DOM, device="cpu")
    assert all(f.device.type == "cpu" for f in fields.values())
