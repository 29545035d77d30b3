"""Forecast-as-a-service on the PyTorch/CUDA port: register a stencil
program with the serving engine, fire concurrent requests, and check that
the batched results match sequential execution bit for bit.

The port of ``examples/serve_forecast.py``: the engine holds the forecast
step's ``cuda`` program hot (its fused groups' generated kernels, one
launch per group and step for all the requests of a window, batched on the
member axis) and each response is the same float64 bits as its request run
alone through the program.

    PYTHONPATH=src python examples/serve_forecast_torch.py
    PYTHONPATH=src python examples/serve_forecast_torch.py --requests 6 --steps 8
    PYTHONPATH=src python examples/serve_forecast_torch.py --device cpu

Without a GPU it says so unless ``--device cpu`` is given.
"""

import argparse
import asyncio
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import storage  # noqa: E402
from repro_torch.core.storage import Storage  # noqa: E402
from repro_torch.serving import RequestSpec, ServingEngine, drive_engine  # noqa: E402
from repro_torch.stencils.forecast import (  # noqa: E402
    FIELD_NAMES,
    build_forecast_step,
    make_forecast_fields,
    request_state,
)

DOM = (24, 24, 8)
BACKEND = "cuda"


def run_sequentially(step, templates, scalars, phi0, steps):
    """The oracle: one request through plain per-call program execution."""
    f = {n: Storage(s.data.clone(), backend=s.backend, default_origin=s.default_origin, axes=s.axes)
         for n, s in templates.items()}
    f["phi"].data.copy_(torch.from_numpy(np.asarray(phi0)))
    for _ in range(steps):
        step(*[f[n] for n in FIELD_NAMES], **scalars)
    return f["phi"].to_numpy()


async def serve(n_requests: int, steps: int, device) -> dict:
    # 1. build + register: compile happens HERE, never on the request path
    step = build_forecast_step(BACKEND, DOM)
    templates, scalars = make_forecast_fields(BACKEND, DOM, device=device)
    engine = ServingEngine(window_ms=5.0)
    entry = engine.register(step, fields=templates, scalars=scalars, request_fields=("phi",),
                            member_counts=(1, 2, 4, 8), warm=True, warm_chunk=2)
    print(f"registered {entry.name!r}  fingerprint={entry.fingerprint}  counts={entry.member_counts}")

    # 2. concurrent clients: each ships its own initial phi
    specs = [RequestSpec(program=entry.name, fields={"phi": request_state(DOM, seed=i + 1)}, steps=steps,
                         stream_every=2, stats=True)
             for i in range(n_requests)]
    async with engine:
        report = await drive_engine(engine, specs)

    # 3. the serving contract: batched == sequential, bit for bit
    finals = []
    for spec, res in zip(specs, report.results):
        ref = run_sequentially(step, templates, scalars, spec.fields["phi"], steps)
        diff = np.abs(res.final_fields["phi"] - ref).max()
        assert diff == 0.0, f"{res.request_id}: batched result diverged by {diff}"
        assert res.in_order
        finals.append(res.final_fields["phi"])
    s = report.summary()
    print(f"{s['requests']} requests  {s['requests_per_second']:.1f} req/s  p50 {s['p50_ms']:.1f} ms  "
          f"p99 {s['p99_ms']:.1f} ms  occupancy {s['mean_occupancy']:.2f}")
    print(f"bit-identical to sequential execution on {device}: OK")
    return {"summary": s, "finals": finals, "requests": [spec.fields["phi"] for spec in specs], "device": str(device)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--device", default="cuda", help="device of the served fields (cpu on a host without a card)")
    args = ap.parse_args(argv)
    return asyncio.run(serve(args.requests, args.steps, storage.resolve_device(args.device)))


if __name__ == "__main__":
    main()
