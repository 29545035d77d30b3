"""Forecast-serving driver: hold a compiled stencil program hot, batch
concurrent requests onto the ensemble member axis, stream steps back.

(The reference package's ``repro/launch/serve.py``, over
``repro_torch.serving``.  Programs build for the ``cuda`` backend and their
fields live on the card unless ``--backend torch`` / ``--device cpu`` say
otherwise.)

Serve the demo forecast program over websockets (needs aiohttp)::

    PYTHONPATH=src python -m repro_torch.launch.serve --port 8765

In-process load test, no network or aiohttp needed (on the card; at the
climate tile's size with ``--domain 256 256 80``)::

    PYTHONPATH=src python -m repro_torch.launch.serve --load 8 --steps 10 --stream-every 2
    PYTHONPATH=src python -m repro_torch.launch.serve --load 16 --domain 256 256 80

Print the catalog a client would see and exit::

    PYTHONPATH=src python -m repro_torch.launch.serve --dry

Run under the process supervisor (spawn → probe /healthz → restart with
backoff → give up on a crash loop)::

    PYTHONPATH=src python -m repro_torch.launch.serve --supervise --port 8765

The server itself shuts down gracefully on SIGTERM: /healthz flips to 503
(``DRAINING``), new requests are rejected, queued and in-flight work is
finished (bounded by ``--drain-timeout``), then the process exits 0 — the
supervisor treats that as a deliberate stop, not a crash.
"""

from __future__ import annotations

import argparse
import asyncio
import functools
import json
import signal
from typing import Tuple

from repro_torch.obs import export as obs_export
from repro_torch.obs import slo as obs_slo
from repro_torch.obs import trace as otrace
from repro_torch.obs.flight import FlightRecorder
from repro_torch.runtime.supervise import RestartPolicy, Supervisor, http_ready
from repro_torch.serving import ProgramEntry, RequestSpec, ServingEngine, drive_engine
from repro_torch.stencils.forecast import build_forecast_step, make_forecast_fields, request_state


def _arm_tracing(args: argparse.Namespace) -> bool:
    """Enable the process tracer when ``--trace-out`` asks for a dump (or
    ``REPRO_TRACE=1`` already armed it); returns whether a dump is due.
    ``--trace-sample`` arms *sampled* always-on tracing: keep/drop is a
    deterministic hash of the request id, error paths are force-sampled."""
    if args.trace_sample is not None:
        otrace.configure(enabled=True, sample_rate=args.trace_sample)
    elif args.trace_out:
        otrace.configure(enabled=True)
    return bool(args.trace_out)


def _build_engine(args: argparse.Namespace) -> ServingEngine:
    """One engine, fully armed from the CLI: flight recorder (``--flight-dir``
    beats ``$REPRO_FLIGHT_DIR``), default SLOs attached per program at
    registration time (see ``_attach_slos``)."""
    flight = FlightRecorder(args.flight_dir) if args.flight_dir else None
    return ServingEngine(
        window_ms=args.window_ms,
        flight=flight,
        scheduler=args.scheduler,
        priority_classes=args.priority_classes,
    )


def _attach_slos(engine: ServingEngine, entry: ProgramEntry, args: argparse.Namespace) -> None:
    if not args.no_slo:
        engine.slo.add(
            *obs_slo.default_objectives(
                entry.name, availability=args.slo_availability, p99_s=args.slo_p99
            )
        )


def _dump_trace(args: argparse.Namespace) -> None:
    data = obs_export.write_chrome_trace(
        args.trace_out, metadata={"entry": "repro_torch.launch.serve", "backend": args.backend}
    )
    n = sum(1 for ev in data["traceEvents"] if ev.get("ph") != "M")
    print(f"wrote {n} trace events to {args.trace_out}", flush=True)


def build_forecast_entry(
    engine: ServingEngine,
    *,
    backend: str = "cuda",
    device=None,
    domain: Tuple[int, int, int] = (48, 48, 16),
    member_counts: Tuple[int, ...] = (1, 2, 4, 8),
    warm: bool = True,
    warm_chunk: int = 1,
) -> ProgramEntry:
    """Register the demo forecast step (advect + euler + diffuse), its
    template fields on ``device`` (the card unless named)."""
    fields, scalars = make_forecast_fields(backend, domain, device=device)
    step = build_forecast_step(backend, domain)
    return engine.register(
        step,
        fields=fields,
        scalars=scalars,
        request_fields=("phi",),
        member_counts=member_counts,
        warm=warm,
        warm_chunk=warm_chunk,
    )


async def _load_test(args: argparse.Namespace) -> None:
    dump = _arm_tracing(args)
    engine = _build_engine(args)
    domain = tuple(args.domain)
    entry = build_forecast_entry(
        engine, backend=args.backend, device=args.device, domain=domain, warm=True,
        warm_chunk=args.stream_every,
    )
    _attach_slos(engine, entry, args)
    specs = [
        RequestSpec(
            program=entry.name,
            fields={"phi": request_state(domain, seed=i + 1)},
            steps=args.steps,
            stream_every=args.stream_every,
        )
        for i in range(args.load)
    ]
    async with engine:
        report = await drive_engine(engine, specs, keep_fields="none")
    s = report.summary()
    print(
        f"{args.load} concurrent requests x {args.steps} steps (stream_every={args.stream_every}) "
        f"on {args.backend} {domain}, device {entry.fields['phi'].device}"
    )
    print(
        f"  {s['requests_per_second']:.1f} req/s  p50 {s['p50_ms']:.1f} ms  "
        f"p99 {s['p99_ms']:.1f} ms  occupancy {s['mean_occupancy']:.2f}"
    )
    print(f"  in order: {report.all_in_order}   engine: {json.dumps(engine.stats())}")
    if dump:
        _dump_trace(args)


async def _serve(args: argparse.Namespace) -> None:
    from repro_torch.serving.server import ForecastServer

    dump = _arm_tracing(args)
    engine = _build_engine(args)
    entry = build_forecast_entry(
        engine, backend=args.backend, device=args.device, domain=tuple(args.domain), warm=not args.no_warm
    )
    _attach_slos(engine, entry, args)
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGTERM, signal.SIGINT):
        loop.add_signal_handler(sig, stop.set)
    # operator's black-box button: SIGUSR2 drops a flight bundle on demand
    # (no-op unless --flight-dir / $REPRO_FLIGHT_DIR armed a recorder)
    loop.add_signal_handler(signal.SIGUSR2, lambda: engine._flight_dump("sigusr2"))
    async with ForecastServer(engine, host=args.host, port=args.port) as srv:
        print(f"forecast server on {srv.ws_url}  (GET /programs for the catalog; SIGTERM drains)", flush=True)
        await stop.wait()
        # graceful drain: /healthz flips to DRAINING (503), new submits are
        # rejected, queued + in-flight requests finish before we exit 0
        print(f"draining (timeout {args.drain_timeout}s) ...", flush=True)
        await engine.drain(timeout_s=args.drain_timeout)
    if dump:
        _dump_trace(args)


def _supervise(args: argparse.Namespace) -> None:
    """Parent mode: spawn the server as a child of this interpreter, probe
    /healthz until ready, restart with backoff when it dies, give up on a
    crash loop (SupervisorGaveUp propagates)."""
    child_args = ["--backend", args.backend, "--domain", *map(str, args.domain),
                  *(["--device", args.device] if args.device else []),
                  "--window-ms", str(args.window_ms), "--host", args.host,
                  "--port", str(args.port), "--drain-timeout", str(args.drain_timeout),
                  "--slo-p99", str(args.slo_p99), "--slo-availability", str(args.slo_availability),
                  "--priority-classes", str(args.priority_classes)]
    if args.scheduler is not None:
        child_args.extend(["--scheduler", args.scheduler])
    if args.no_warm:
        child_args.append("--no-warm")
    if args.no_slo:
        child_args.append("--no-slo")
    if args.trace_sample is not None:
        child_args.extend(["--trace-sample", str(args.trace_sample)])
    if args.flight_dir:
        child_args.extend(["--flight-dir", args.flight_dir])
    from repro_torch.runtime.supervise import serve_command

    url = f"http://{args.host}:{args.port}/healthz"
    sup = Supervisor(
        serve_command(child_args),
        probe=functools.partial(http_ready, url),
        policy=RestartPolicy(),
        ready_timeout_s=args.ready_timeout,
        # the supervisor's own bundles (restart cadence, exit codes) land in
        # the same directory as the child's in-process ones
        flight=FlightRecorder(args.flight_dir) if args.flight_dir else None,
    )

    def _forward(signum, _frame):
        sup.stop()
        raise SystemExit(0)

    signal.signal(signal.SIGTERM, _forward)
    signal.signal(signal.SIGINT, _forward)
    print(f"supervising forecast server (probe {url})", flush=True)
    sup.run_forever()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--backend", default="cuda", choices=["cuda", "torch"])
    ap.add_argument("--device", default=None,
                    help="device of the template fields (default: the card, cuda)")
    ap.add_argument("--domain", type=int, nargs=3, default=[48, 48, 16], metavar=("NI", "NJ", "NK"))
    ap.add_argument("--window-ms", type=float, default=2.0, help="batching window")
    ap.add_argument("--scheduler", default=None, choices=["fifo", "edf"],
                    help="batching scheduler policy (default: $REPRO_SCHEDULER or edf — "
                         "earliest-deadline-first within priority classes)")
    ap.add_argument("--priority-classes", type=int, default=3, metavar="N",
                    help="number of request priority classes the engine accepts "
                         "(priorities 0..N-1, lower = more urgent)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8765)
    ap.add_argument("--no-warm", action="store_true", help="skip warming every member count")
    ap.add_argument("--load", type=int, default=0, help="run an in-process load test with N requests")
    ap.add_argument("--steps", type=int, default=10, help="(--load) steps per request")
    ap.add_argument("--stream-every", type=int, default=2, help="(--load) stream cadence")
    ap.add_argument("--dry", action="store_true", help="print the catalog and exit")
    ap.add_argument("--supervise", action="store_true",
                    help="run the server as a supervised child (restart with backoff)")
    ap.add_argument("--drain-timeout", type=float, default=10.0,
                    help="seconds to finish in-flight work on SIGTERM before exiting")
    ap.add_argument("--ready-timeout", type=float, default=120.0,
                    help="(--supervise) seconds for /healthz to come up before counting a crash")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="arm span tracing and write a Chrome-trace/Perfetto JSON dump "
                         "on exit (serve mode) or after the run (--load mode)")
    ap.add_argument("--trace-sample", type=float, default=None, metavar="RATE",
                    help="arm ALWAYS-ON tracing at this head-sampling rate in [0,1] "
                         "(deterministic per request id; error paths always kept); "
                         "also honors REPRO_TRACE_SAMPLE")
    ap.add_argument("--flight-dir", default=None, metavar="DIR",
                    help="arm the failure flight recorder: JSON black-box bundles land "
                         "here on worker death, SLO breach, crash-loop give-up, SIGUSR2 "
                         "(also honors REPRO_FLIGHT_DIR)")
    ap.add_argument("--slo-p99", type=float, default=0.5, metavar="SECONDS",
                    help="p99 latency SLO target for the served program")
    ap.add_argument("--slo-availability", type=float, default=0.999, metavar="FRACTION",
                    help="availability SLO target for the served program")
    ap.add_argument("--no-slo", action="store_true", help="disable the default SLO objectives")
    args = ap.parse_args()

    if args.dry:
        engine = ServingEngine(window_ms=args.window_ms)
        entry = build_forecast_entry(engine, backend=args.backend, device=args.device, domain=tuple(args.domain),
                                     warm=False)
        print(json.dumps(entry.describe(), indent=2))
        return
    if args.load:
        asyncio.run(_load_test(args))
        return
    if args.supervise:
        _supervise(args)
        return
    try:
        asyncio.run(_serve(args))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
