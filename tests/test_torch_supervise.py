"""Process supervision tests (repro.runtime.supervise): restart policy math,
readiness probing, restart-on-crash, crash-loop give-up — with cheap stdlib
child processes (no aiohttp, no jax import in the children) — plus the
failure flight recorder riding both layers: the supervisor dumps an
outside-view bundle before every restart / at give-up, and the engine's
worker-death path dumps an in-process black box whose spans identify the
poison request that took the worker down."""

import asyncio
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from repro_torch.obs import flight as obs_flight
from repro_torch.obs import trace as otrace
from repro_torch.runtime.supervise import (
    RestartPolicy,
    StragglerWatchdog,
    Supervisor,
    SupervisorGaveUp,
    http_ready,
    serve_command,
)

# ---------------------------------------------------------------------------
# restart policy: backoff progression + crash-loop detection
# ---------------------------------------------------------------------------


def test_backoff_progression_and_reset():
    p = RestartPolicy(backoff_s=0.5, backoff_factor=2.0, backoff_max_s=3.0)
    assert [p.next_backoff() for _ in range(4)] == [0.5, 1.0, 2.0, 3.0]  # capped
    p.reset_backoff()
    assert p.next_backoff() == 0.5


def test_crash_loop_detection_window():
    p = RestartPolicy(crash_window_s=10.0, max_crashes=3)
    assert not p.record_crash(now=0.0)
    assert not p.record_crash(now=1.0)
    assert p.record_crash(now=2.0)  # 3 crashes within 10s → loop
    # old crashes age out of the window
    p2 = RestartPolicy(crash_window_s=10.0, max_crashes=3)
    assert not p2.record_crash(now=0.0)
    assert not p2.record_crash(now=20.0)
    assert not p2.record_crash(now=40.0)  # never 3 within any 10s window


def test_http_ready_refuses_dead_endpoint():
    assert not http_ready("http://127.0.0.1:1/healthz", timeout_s=0.2)


def test_serve_command_shape():
    cmd = serve_command(["--port", "9999", "--no-warm"])
    assert cmd[0] == sys.executable
    assert cmd[1:3] == ["-m", "repro_torch.launch.serve"]
    assert cmd[3:] == ["--port", "9999", "--no-warm"]


# ---------------------------------------------------------------------------
# the supervisor against real (tiny) child processes
# ---------------------------------------------------------------------------


def _touch_and_sleep_cmd(marker: Path, sleep_s: float = 60.0):
    """A child that signals readiness by touching a file, then idles."""
    return [
        sys.executable,
        "-c",
        f"import pathlib, time; pathlib.Path({str(marker)!r}).touch(); time.sleep({sleep_s})",
    ]


def test_supervisor_spawns_and_probes_ready(tmp_path):
    marker = tmp_path / "ready"
    sup = Supervisor(
        _touch_and_sleep_cmd(marker),
        probe=marker.exists,
        ready_timeout_s=15.0,
        probe_interval_s=0.02,
    )
    sup.start()
    try:
        assert marker.exists()
        assert sup.proc is not None and sup.proc.poll() is None
        assert sup.stats == {"spawns": 1, "crashes": 0, "restarts": 0}
    finally:
        sup.stop()
    assert sup.proc is None


def test_supervisor_restarts_killed_child_and_recovers(tmp_path):
    """The acceptance path: force-kill the child; the supervisor respawns it
    and the readiness probe comes back."""
    marker = tmp_path / "ready"
    events = []
    sup = Supervisor(
        _touch_and_sleep_cmd(marker),
        probe=marker.exists,
        policy=RestartPolicy(backoff_s=0.05, max_crashes=10),
        ready_timeout_s=15.0,
        probe_interval_s=0.02,
        on_event=lambda kind, detail: events.append(kind),
    )
    sup.start()
    runner = threading.Thread(target=sup.run_forever, daemon=True)
    runner.start()
    try:
        first_pid = sup.proc.pid
        marker.unlink()  # probe goes dark...
        sup.proc.kill()  # ...and the child is gone
        deadline = time.monotonic() + 15.0
        while time.monotonic() < deadline:
            if events.count("ready") >= 2 and sup.proc is not None and sup.proc.pid != first_pid:
                break
            time.sleep(0.02)
        assert marker.exists(), "supervisor never restored readiness"
        assert sup.proc.pid != first_pid and sup.proc.poll() is None
        assert sup.stats["restarts"] >= 1 and sup.stats["crashes"] >= 1
        assert "crashed" in events and events.count("ready") >= 2
    finally:
        sup.stop()
        runner.join(timeout=10.0)
    assert not runner.is_alive()  # stop() ends run_forever cleanly


def test_supervisor_gives_up_on_crash_loop():
    """A child that exits immediately can never become ready: after
    max_crashes rapid exits the supervisor raises instead of spinning."""
    sup = Supervisor(
        [sys.executable, "-c", "raise SystemExit(3)"],
        probe=lambda: False,
        policy=RestartPolicy(backoff_s=0.01, backoff_max_s=0.02, crash_window_s=60.0, max_crashes=3),
        ready_timeout_s=0.3,
        probe_interval_s=0.02,
    )
    with pytest.raises(SupervisorGaveUp, match="3 crashes"):
        sup.start()
    assert sup.stats["crashes"] == 3


def test_supervisor_counts_ready_timeout_as_crash(tmp_path):
    """A child that stays alive but never probes ready is killed and counted
    as a crash (it would otherwise wedge the fleet as 'starting forever')."""
    sup = Supervisor(
        [sys.executable, "-c", "import time; time.sleep(60)"],
        probe=lambda: False,
        policy=RestartPolicy(backoff_s=0.01, backoff_max_s=0.02, max_crashes=2),
        ready_timeout_s=0.2,
        probe_interval_s=0.02,
    )
    t0 = time.monotonic()
    with pytest.raises(SupervisorGaveUp):
        sup.start()
    assert time.monotonic() - t0 < 10.0
    assert sup.stats["crashes"] == 2
    assert sup.proc.poll() is not None  # no zombie child left behind


def test_stop_is_idempotent_and_detaches(tmp_path):
    marker = tmp_path / "ready"
    sup = Supervisor(
        _touch_and_sleep_cmd(marker),
        probe=marker.exists,
        ready_timeout_s=15.0,
        probe_interval_s=0.02,
    )
    sup.start()
    proc = sup.proc
    sup.stop()
    sup.stop()  # second stop is a no-op
    assert proc.poll() is not None and sup.proc is None


# ---------------------------------------------------------------------------
# the flight recorder rides the supervisor: outside-view bundles per restart
# ---------------------------------------------------------------------------


def test_supervisor_dumps_flight_bundles_on_restart_and_give_up(tmp_path):
    """Before every restart (and at give-up) the supervisor drops a black-box
    bundle capturing the dead child's exit state and the restart cadence."""
    flight_dir = tmp_path / "flight"
    sup = Supervisor(
        [sys.executable, "-c", "raise SystemExit(3)"],
        probe=lambda: False,
        policy=RestartPolicy(backoff_s=0.01, backoff_max_s=0.02, crash_window_s=60.0, max_crashes=3),
        ready_timeout_s=0.3,
        probe_interval_s=0.02,
        flight=obs_flight.FlightRecorder(flight_dir),
    )
    with pytest.raises(SupervisorGaveUp):
        sup.start()

    bundles = [obs_flight.load_bundle(p) for p in sorted(flight_dir.glob("flight-*.json"))]
    reasons = [b["reason"] for b in bundles]
    # crashes 1..2 dump "supervisor_restart" before backing off; crash 3 hits
    # the loop detector and dumps "supervisor_gave_up" before raising
    assert reasons.count("supervisor_restart") == 2
    assert reasons.count("supervisor_gave_up") == 1
    for b in bundles:
        assert b["stats"]["child_returncode"] == 3
        assert b["stats"]["crashes"] >= 1
        assert "cmd" in b["config"]
    gave_up = bundles[reasons.index("supervisor_gave_up")]
    assert gave_up["stats"]["crashes_in_window"] == 3
    assert gave_up["extra"]["why"] == "never became ready"


def test_supervisor_from_env_arms_flight_recorder(tmp_path, monkeypatch):
    """$REPRO_FLIGHT_DIR alone (no explicit recorder) arms the supervisor —
    the same env var the child inherits for its in-process bundles."""
    monkeypatch.setenv("REPRO_FLIGHT_DIR", str(tmp_path / "env-flight"))
    sup = Supervisor([sys.executable, "-c", "pass"], probe=lambda: False)
    assert sup.flight is not None
    assert sup.flight.out_dir == tmp_path / "env-flight"
    monkeypatch.delenv("REPRO_FLIGHT_DIR")
    sup2 = Supervisor([sys.executable, "-c", "pass"], probe=lambda: False)
    assert sup2.flight is None


# ---------------------------------------------------------------------------
# end-to-end: worker death under a poison request → the black box tells the
# whole story (spans + metrics + stats naming the poison id)
# ---------------------------------------------------------------------------


def test_worker_death_black_box_identifies_poison_request(tmp_path):
    """The acceptance path for the flight recorder: a poison request churns
    through retry → bisect → failure (its spans force-sampled past a 10%
    head-sampling rate), then the worker task itself dies.  The worker-death
    bundle must be a self-contained story: the poison request id is
    recoverable from the spans, the error shows in the metrics and stats,
    and ``python -m repro.obs.flight`` accepts the file."""
    from repro_torch.serving import FaultInjector, RequestSpec, ServingEngine, drive_engine
    from repro_torch.stencils.forecast import build_forecast_step, make_forecast_fields, request_state

    dom = (10, 8, 4)
    poison = "poison-req-1"
    tracer = otrace.Tracer(enabled=True, sample_rate=0.1)
    eng = ServingEngine(
        window_ms=25.0,
        retry_backoff_ms=1.0,
        faults=FaultInjector(sites=("dispatch",), rate=0.0, poison=(poison,)),
        tracer=tracer,
        flight=obs_flight.FlightRecorder(tmp_path / "flight"),
    )
    fields, scalars = make_forecast_fields("torch", dom, device="cpu")
    eng.register(
        build_forecast_step("torch", dom, name="box_step"),
        fields=fields,
        scalars=scalars,
        request_fields=("phi",),
        member_counts=(1, 2),
        max_steps=100,
    )
    specs = [
        RequestSpec(
            program="box_step",
            fields={"phi": request_state(dom, seed=i + 1)},
            steps=2,
            stream_every=1,
            request_id=poison if i == 0 else f"ok-{i}",
        )
        for i in range(2)
    ]

    async def suicidal():
        raise RuntimeError("simulated hard worker fault")

    async def go():
        async with eng:
            report = await drive_engine(eng, specs, keep_fields="none")
            assert sum(not r.ok for r in report.results) == 1
            # now the worker itself dies; its done-callback dumps the box
            task = asyncio.get_running_loop().create_task(suicidal())
            eng._worker = task
            task.add_done_callback(eng._worker_died)
            await asyncio.sleep(0.05)

    asyncio.run(go())

    path = eng.flight.last_bundle
    assert path is not None
    bundle = obs_flight.load_bundle(path)
    assert bundle["reason"] == "worker_death"
    assert "RuntimeError: simulated hard worker fault" in bundle["extra"]["error"]
    # the spans name the poison request and carry its whole failure arc,
    # despite the 10% sampling rate (error paths are force-sampled)
    story = obs_flight.request_story(bundle, poison)
    names = {ev["name"] for ev in story}
    assert {"serving.retry", "serving.bisect", "serving.request_failed"} <= names
    # metrics + stats corroborate: exactly one failed request, program-labeled
    errors = bundle["metrics"]["serving_errors_total"]
    assert any("program=box_step" in k for k in errors)
    assert sum(errors.values()) == 1
    assert bundle["stats"]["errors"] == 1
    assert bundle["stats"]["per_program"]["box_step"]["retries"] >= 1
    # the CLI agrees the bundle is well-formed and can replay the story
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.flight", str(path), "--request", poison],
        capture_output=True,
        text=True,
        env={"PYTHONPATH": "src", "PATH": "/usr/bin:/bin"},
        cwd=str(Path(__file__).resolve().parent.parent),
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert poison in proc.stdout and "serving.bisect" in proc.stdout


# ---------------------------------------------------------------------------
# the watchdog, and its re-export by the runtime package
# ---------------------------------------------------------------------------


def test_watchdog_flags_stragglers_and_reexports():
    from repro_torch.runtime import StragglerWatchdog as FromPackage

    assert FromPackage is StragglerWatchdog  # the package re-exports it
    flagged = []
    wd = StragglerWatchdog(factor=3.0, on_straggler=lambda s, dt, med: flagged.append(s))
    for i in range(10):
        wd.record(i, 0.01)
    assert wd.stats.median_s == pytest.approx(0.01)
    assert wd.record(10, 0.5)  # 50× the median
    assert flagged == [10] and wd.stats.stragglers == 1
