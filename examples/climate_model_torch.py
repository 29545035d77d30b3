"""A miniature climate-model driver on the PyTorch/CUDA port: horizontal
upwind advection + horizontal diffusion (paper Fig. 1) + implicit vertical
advection (paper Fig. 3 right), time-stepped.

The port of ``examples/climate_model.py``, on its step as the port's library
holds it (``repro_torch.stencils.climate``).  The default driver is the
``@program`` (on the ``cuda`` backend two generated kernels a step, one per
fused group); ``--eager`` runs the five stencils one after the other (five
launches a step), and ``--compare`` runs both and reports the wall-time
ratio and the largest deviation.  ``--members N`` runs an N-member ensemble
(phi perturbed, member 0 the control; one launch per group and step for all
members) and prints its spread statistics.

    PYTHONPATH=src python examples/climate_model_torch.py --nt 50 --compare
    PYTHONPATH=src python examples/climate_model_torch.py --nt 10 --members 21
    PYTHONPATH=src python examples/climate_model_torch.py --nt 5 --device cpu

The default backend is ``cuda`` and the default device the card; without a
GPU it says so unless ``--device cpu`` is given (the ``cuda`` backend then
runs each kernel's plain torch module).
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import numpy as np  # noqa: E402

from repro_torch import ensemble  # noqa: E402
from repro_torch.core import codegen_cuda, storage  # noqa: E402
from repro_torch.stencils import climate  # noqa: E402

H = climate.HALO
FIELD_NAMES = climate.FIELD_NAMES
SHARED = ("u", "v", "w")  # the winds: one copy, read by every member


def field_arrays(ni, nj, nk, seed=0):
    """The reference's initial state: a gaussian tracer blob, steady winds,
    a random vertical wind, zero workspace; (ni + 2H, nj + 2H, nk) each."""
    shape = (ni + 2 * H, nj + 2 * H, nk)
    rng = np.random.default_rng(seed)
    xx, yy = np.meshgrid(np.linspace(-2, 2, shape[0]), np.linspace(-2, 2, shape[1]), indexing="ij")
    out = {n: np.zeros(shape) for n in FIELD_NAMES}
    out["phi"] = np.exp(-(xx**2 + yy**2))[:, :, None] * np.ones((1, 1, nk))
    out["u"] = np.full(shape, 0.8)
    out["v"] = np.full(shape, -0.4)
    out["w"] = 0.2 * rng.random(shape)
    return out


def make_fields(backend, arrays, device):
    kw = {"device": device} if backend in storage.TORCH_BACKENDS else {}
    return {n: storage.from_array(a, backend=backend, default_origin=(H, H, 0), **kw) for n, a in arrays.items()}


def run_eager(stencils, fields, dom, nt, scalars):
    for _ in range(nt):
        climate.eager_step(stencils, fields, dom, scalars)
    return fields["phi"]


def run_program(step, fields, nt, scalars, exec_info=None):
    args = [fields[n] for n in FIELD_NAMES]
    for t in range(nt):
        step(*args, **scalars, exec_info=exec_info if t == 0 else None)
    return fields["phi"]


def member_fields(fields, members, batched_phi=None, seed=0, amplitude=1e-3):
    """The ensemble's fields: phi perturbed per member (member 0 the control;
    or ``batched_phi``, the members' initial phi, when given), the winds
    shared, the workspace one copy a member."""
    out = {}
    for n in FIELD_NAMES:
        f = fields[n]
        if n == "phi":
            out[n] = (ensemble.perturb(f, members, seed=seed, amplitude=amplitude, perturb_member0=False)
                      if batched_phi is None else
                      ensemble.from_member_arrays(list(batched_phi), backend=f.backend, default_origin=(H, H, 0),
                                                  device=f.device))
        elif n in SHARED:
            out[n] = f
        else:
            out[n] = ensemble.broadcast(f, members, backend=f.backend)
    return out


def run_ensemble(step, batched, nt, scalars, members):
    """``Ensemble(step, members).iterate(nt)`` on the member fields (in
    place), then the spread statistics of phi."""
    ens = ensemble.Ensemble(step, members)
    ens.iterate(nt, *[batched[n] for n in FIELD_NAMES], **scalars)
    return ens.statistics()(batched["phi"], threshold=0.5)


def _launches() -> int:
    return sum(codegen_cuda.launch_counts().values())


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--nx", type=int, default=64)
    ap.add_argument("--ny", type=int, default=64)
    ap.add_argument("--nz", type=int, default=16)
    ap.add_argument("--nt", type=int, default=50)
    ap.add_argument("--backend", default="cuda")
    ap.add_argument("--eager", action="store_true", help="per-stencil launches instead of the fused program")
    ap.add_argument("--compare", action="store_true", help="run both drivers, report ratio and max deviation")
    ap.add_argument("--members", type=int, default=0,
                    help="run an N-member ensemble forecast (one launch per group and step for all members) "
                         "and print the spread statistics")
    ap.add_argument("--device", default="cuda", help="device of the fields (cpu on a host without a card)")
    args = ap.parse_args(argv)

    ni, nj, nk = args.nx, args.ny, args.nz
    be = args.backend
    device = storage.resolve_device(args.device) if be in storage.TORCH_BACKENDS else None
    dom = (ni, nj, nk)
    scalars = dict(climate.DEFAULT_SCALARS)
    arrays = field_arrays(ni, nj, nk)
    stencils = climate.build_stencils(be)
    out = {"backend": be, "device": str(device), "domain": dom, "nt": args.nt}

    def timed(driver):
        fields = make_fields(be, arrays, device)
        total0 = float(arrays["phi"][H:-H, H:-H].sum())
        fields["phi"].synchronize()
        n0, t0 = _launches(), time.perf_counter()
        phi = driver(fields)
        phi.synchronize()
        return {"wall_s": time.perf_counter() - t0, "phi": phi.to_numpy(), "total0": total0,
                "launches_per_step": (_launches() - n0) / args.nt}

    if args.members:
        step = climate.build_program(be, dom, stencils=stencils)
        batched = member_fields(make_fields(be, arrays, device), args.members)
        batched["phi"].synchronize()
        n0, t0 = _launches(), time.perf_counter()
        stats = run_ensemble(step, batched, args.nt, scalars, args.members)
        batched["phi"].synchronize()
        wall = time.perf_counter() - t0
        pts = args.members * args.nt * ni * nj * nk
        print(f"ensemble: {args.members} members x {args.nt} steps of {ni}x{nj}x{nk} "
              f"in {wall:.2f}s ({pts / wall / 1e6:.1f} Mpts/s, {args.members * args.nt / wall:.0f} member-steps/s, "
              f"{_launches() - n0} launches)")
        spread = stats["spread"].to_numpy()[H:-H, H:-H]
        prob = stats["prob"].to_numpy()[H:-H, H:-H]
        print(f"ensemble: mean spread {spread.mean():.3e}, max spread {spread.max():.3e}, "
              f"P(phi>0.5) coverage {prob.mean():.4f}")
        assert np.isfinite(spread).all()
        out["ensemble"] = {"wall_s": wall, "launches": _launches() - n0, "phi": batched["phi"].to_numpy(),
                           "stats": {k: v.to_numpy() for k, v in stats.items()}}
        return out

    results = {}
    if args.compare or not args.eager:
        step = climate.build_program(be, dom, stencils=stencils)
        info = {}
        results["program"] = timed(lambda f: run_program(step, f, args.nt, scalars, exec_info=info))
        rep = info.get("program_report", {})
        print(f"program: {rep.get('nodes')} stencils -> {rep.get('groups')} fused group(s), "
              f"eliminated temporaries {rep.get('eliminated_temporaries')}, rotation {rep.get('rotation')}")
    if args.compare or args.eager:
        results["eager"] = timed(lambda f: run_eager(stencils, f, dom, args.nt, scalars))

    for name, r in results.items():
        interior = r["phi"][H:-H, H:-H]
        print(f"{name}: backend={be} on {device}: {args.nt} steps of {ni}x{nj}x{nk} in {r['wall_s']:.2f}s "
              f"({args.nt * ni * nj * nk / r['wall_s'] / 1e6:.1f} Mpts/s, {r['launches_per_step']:g} launches a step)")
        print(f"{name}: tracer total {r['total0']:.3f} -> {interior.sum():.3f}, "
              f"max {interior.max():.4f}, min {interior.min():.4f}")
        assert np.isfinite(interior).all()
    out.update(results)

    if args.compare:
        p, e = results["program"], results["eager"]
        dev = float(np.abs(p["phi"] - e["phi"]).max())
        print(f"compare: program/eager wall ratio {p['wall_s'] / e['wall_s']:.3f}, max deviation {dev:.3e}")
        out["max_deviation"] = dev
    return out


if __name__ == "__main__":
    main()
