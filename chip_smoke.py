#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result line:

1. environment: the card's name and power limit, torch, CUDA and nvcc versions;
2. build: every stencil below is generated and compiled with nvcc (sm_90a),
   all sources at once, into ``.gt_cache_torch/``;
3. kernel vs plain: each generated kernel against the plain torch backend on
   the same CUDA inputs, float64 and float32, at 256 x 256 x 80 and on a
   ragged domain; the hdiff and vadv kernels also against their hand-written
   oracles (``kernels/*/ref.py``), vadv's residual, and the stencil corpus;
4. the paths, each with every launch count zeroed just before it and read
   just after: the kernel entry points (``ops.hdiff``, ``ops.vadv``), and the
   eager climate step advect → euler → diffuse → vadv_system → vadv for 10
   steps at 256 x 256 x 80 float64 on ``storage`` fields, held against the
   same step on the torch backend and, on a small domain, the numpy backend;
5. times: every kernel of the paths by CUDA events beside its plain version,
   the one PyTorch call that computes the same function where there is one
   (euler: ``torch.add``; diffuse: ``conv3d``), and the least time the card
   could take (its bound); ``ops.hdiff`` and ``ops.vadv`` also end to end.

The corpus programs the cuda backend rejects must be exactly those the
reference's Pallas limit rejects.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

DOMAIN = (256, 256, 80)  # one GPU's subdomain: 80 levels, as COSMO-1's column
RAGGED = (37, 53, 17)
H = 3  # halo of the climate step and of hdiff
NSTEPS = 10
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_FLOPS = {"float64": 34e12, "float32": 67e12}  # H100 SXM, outside the tensor cores
TOL = {"float64": (1e-12, 1e-12), "float32": (1e-5, 1e-5)}  # (rtol, atol) kernel vs plain


def log(msg: str = "") -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.core import codegen_cuda, gtscript, ir, ir_json, storage
    from repro_torch.core.gtscript import GTScriptSemanticError
    from repro_torch.core.stencil import build_from_definition
    from repro_torch.kernels.hdiff import ops as hdiff_ops
    from repro_torch.kernels.hdiff.ref import hdiff_ref
    from repro_torch.kernels.vadv import ops as vadv_ops
    from repro_torch.kernels.vadv.ref import vadv_ref
    from repro_torch.stencils import forecast, hdiff, vadv, vintg

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---------------------------------------------------------------- 1. environment
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    card = smi
    log(smi)
    nvcc = subprocess.run([codegen_cuda.nvcc_path(), "--version"], capture_output=True, text=True, check=True)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}, "
        f"count {torch.cuda.device_count()}, {nvcc.stdout.strip().splitlines()[-1]}")

    # ---------------------------------------------------------------- 2. build
    t0 = time.perf_counter()
    build = {be: gtscript.stencil(backend=be) for be in ("cuda", "torch")}
    S = {}  # name -> {"cuda": StencilObject, "torch": StencilObject}
    for dt in ("float64", "float32"):
        S[f"hdiff/{dt}"] = {"cuda": hdiff_ops.stencil_object(dt), "torch": hdiff.build_hdiff("torch", dtype=dt)}
        S[f"vadv/{dt}"] = {"cuda": vadv_ops.stencil_object(dt), "torch": vadv.build_vadv("torch", dtype=dt)}
    S["hdiff_nolimit/float64"] = {be: hdiff.build_hdiff(be, lim=-1e30) for be in ("cuda", "torch")}
    S["hdiff_smag/float64"] = {be: hdiff.build_hdiff_smag(be) for be in ("cuda", "torch")}
    S["vadv_boundary/float64"] = {be: vadv.build_vadv_boundary(be) for be in ("cuda", "torch")}
    S["vintg/float64"] = {be: vintg.build_vintg(be) for be in ("cuda", "torch")}
    climate_defs = {
        "advect": forecast.advect_defs,
        "euler": forecast.euler_defs,
        "diffuse": forecast.diffuse_defs,
        "vadv_system": vadv.vadv_system_defs,
        "vadv": vadv.vadv_defs,
    }
    for name, defs in climate_defs.items():
        S[f"climate.{name}"] = {be: build[be](defs) for be in ("cuda", "torch")}
    corpus = {}
    rejected, expected_rejected = [], []
    for path in sorted((ROOT / "tests" / "corpus").glob("prog_*.json")):
        defn = ir_json.load_program(path)
        if not ir_json.pallas_compatible(defn):
            expected_rejected.append(path.stem)
        try:
            corpus[path.stem] = {
                be: build_from_definition(defn, be, backend_opts={"opt_level": 3}) for be in ("cuda", "torch")
            }
        except GTScriptSemanticError as e:
            if "horizontal offset" not in str(e):
                raise
            rejected.append(path.stem)
    # only the reference's own limit (a written API field read at a horizontal
    # offset) may reject a corpus program; any other rejection is a fault
    if rejected != expected_rejected:
        raise AssertionError(f"corpus: cuda rejected {rejected}, the reference's limit rejects "
                             f"{expected_rejected}")
    kernels = [s["cuda"].kernel for s in list(S.values()) + list(corpus.values())]
    for k in kernels:
        k.start_build()
    for k in kernels:
        k.finish_build()
    log(f"build: {len(S) + len(corpus)} stencils, {len({k.key for k in kernels})} CUDA sources compiled "
        f"for sm_90a in {time.perf_counter() - t0:.1f} s (corpus programs rejected by the written-API "
        f"limit: {rejected})")

    # ---------------------------------------------------------------- 3. kernel vs plain
    rng = np.random.default_rng(2024)

    def field_arrays(st, domain, dtype):
        shape = (domain[0] + 2 * H, domain[1] + 2 * H, domain[2])
        out = {}
        for n, info in st.field_info.items():
            if info.axes != ("I", "J", "K"):
                raise AssertionError(f"{st.name}: smoke inputs are IJK fields only")
            out[n] = torch.from_numpy(rng.normal(size=shape)).to(dev, getattr(torch, dtype))
        return out

    def diagonally_dominant(fields):
        # |a| + |c| well below b: Thomas is then stable and the kernel's FMAs
        # stay at rounding level against the plain version
        fields["a"] *= 0.1
        fields["c"] *= 0.1
        fields["b"] = fields["b"].abs() + 2.0

    def compare(name, pair, fields, scalars, domain, origin, dtype):
        rtol, atol = TOL[dtype]
        outs = {}
        for be in ("cuda", "torch"):
            work = {n: t.clone() for n, t in fields.items()}
            pair[be](**work, **scalars, domain=domain, origin=origin)
            outs[be] = work
        torch.cuda.synchronize()
        err = 0.0
        for n in pair["cuda"].implementation_ir.written_api_fields():
            a, b = outs["cuda"][n], outs["torch"][n]
            if not torch.isfinite(a).all():
                raise AssertionError(f"{name}: non-finite kernel output {n!r}")
            err = max(err, float((a - b).abs().max()))
            if not torch.allclose(a, b, rtol=rtol, atol=atol):
                raise AssertionError(f"{name}: kernel differs from plain on {n!r} by {err:.3e}")
        log(f"check {name:28s} {str(domain):16s} max_abs_err {err:.3e} (rtol {rtol:g}, atol {atol:g}) "
            f"launches {pair['cuda'].launches}")
        return err

    err_at_full = {}
    scal = {
        "hdiff": {"alpha": 0.05}, "hdiff_nolimit": {"alpha": 0.05}, "hdiff_smag": {"dt": 0.1},
        "vadv": {}, "vadv_boundary": {"weight": 0.7}, "vintg": {"decay": 0.9},
        "climate.advect": {"dx": 1.0, "dy": 1.0}, "climate.euler": {"dt": 0.1},
        "climate.diffuse": {"alpha": 0.05}, "climate.vadv_system": {"dt": 0.1, "dz": 1.0},
        "climate.vadv": {},
    }
    for key, pair in S.items():
        name, dtype = (key.split("/") + ["float64"])[:2]
        for domain in (DOMAIN, RAGGED):
            fields = field_arrays(pair["cuda"], domain, dtype)
            if name in ("vadv", "climate.vadv"):
                diagonally_dominant(fields)
            e = compare(key, pair, fields, scal[name], domain, (H, H, 0), dtype)
            if domain == DOMAIN and dtype == "float64":
                err_at_full[name] = e

    # the kernel entry points against their hand-written oracles
    x = torch.from_numpy(rng.normal(size=(DOMAIN[0] + 6, DOMAIN[1] + 6, DOMAIN[2]))).to(dev)
    e = float((hdiff_ops.hdiff(x, 0.05) - hdiff_ref(x, 0.05)).abs().max())
    log(f"check ops.hdiff vs ref.hdiff_ref {DOMAIN} max_abs_err {e:.3e} (atol 1e-12)")
    if not e <= 1e-12:
        raise AssertionError("ops.hdiff differs from hdiff_ref")
    a, b, c, d = (torch.from_numpy(v).to(dev) for v in (
        rng.normal(size=DOMAIN) * 0.2, 3.0 + rng.random(DOMAIN), rng.normal(size=DOMAIN) * 0.2,
        rng.normal(size=DOMAIN)))
    xs = vadv_ops.vadv(a, b, c, d)
    e = float((xs - vadv_ref(a, b, c, d)).abs().max())
    resid = b * xs - d
    resid[..., 1:] += a[..., 1:] * xs[..., :-1]
    resid[..., :-1] += c[..., :-1] * xs[..., 1:]
    r = float(resid.abs().max())
    log(f"check ops.vadv vs ref.vadv_ref {DOMAIN} max_abs_err {e:.3e} (atol 1e-10); residual {r:.3e} (< 1e-8)")
    if not (e <= 1e-10 and r < 1e-8):
        raise AssertionError("ops.vadv differs from vadv_ref or does not solve the system")

    # the stencil corpus, at its own small domain (halo 6)
    cn, ch = (6, 5, 7), 6
    worst = 0.0
    for pname, pair in corpus.items():
        shape = (cn[0] + 2 * ch, cn[1] + 2 * ch, cn[2])
        fields = {n: torch.from_numpy(rng.normal(size=shape)).to(dev) for n in pair["cuda"].field_info}
        outs = {}
        for be in ("cuda", "torch"):
            work = {n: t.clone() for n, t in fields.items()}
            pair[be](**work, s=0.37, domain=cn, origin=(ch, ch, 0))
            outs[be] = work
        for n in pair["cuda"].implementation_ir.written_api_fields():
            worst = max(worst, float((outs["cuda"][n] - outs["torch"][n]).abs().max()))
            if not torch.allclose(outs["cuda"][n], outs["torch"][n], rtol=1e-12, atol=1e-12):
                raise AssertionError(f"corpus {pname}: kernel differs from plain on {n!r}")
    log(f"check corpus: {len(corpus)} programs, max_abs_err {worst:.3e} (rtol 1e-12, atol 1e-12)")

    # ---------------------------------------------------------------- 4. the paths
    def only_these_ran(path_name, launches):
        """The module-level counts (every live kernel) hold no launch beyond
        the path's own kernels."""
        total = sum(codegen_cuda.launch_counts().values())
        if total != sum(launches.values()):
            raise AssertionError(f"{path_name}: {total} launches in all, {launches} on the path")

    # path A: the kernel entry points, as a user calls them
    phi0 = torch.from_numpy(rng.normal(size=(DOMAIN[0] + 6, DOMAIN[1] + 6, DOMAIN[2]))).to(dev)
    codegen_cuda.reset_launch_counts()
    smoothed = hdiff_ops.hdiff(phi0, 0.05)
    solved = vadv_ops.vadv(a, b, c, smoothed[3:-3, 3:-3, :].contiguous())
    torch.cuda.synchronize()
    launches = {"hdiff": S["hdiff/float64"]["cuda"].launches, "vadv": S["vadv/float64"]["cuda"].launches}
    if not torch.isfinite(solved).all() or min(launches.values()) == 0:
        raise AssertionError(f"kernel entry points: launches {launches}")
    only_these_ran("kernel entry points", launches)
    log(f"path kernels: ops.hdiff -> ops.vadv at {DOMAIN}, launches {launches}")

    # path B: the eager climate step on storage fields
    names = ("phi", "u", "v", "w", "adv", "phi_star", "phi_h", "a", "b", "c", "d", "phi_new")
    scalars = {"dt": 0.1, "dx": 1.0, "dy": 1.0, "dz": 1.0, "alpha": 0.05}

    def climate_arrays(domain):
        ni, nj, nk = domain
        shape = (ni + 2 * H, nj + 2 * H, nk)
        g = np.random.default_rng(7)
        xx, yy = np.meshgrid(np.linspace(-2, 2, shape[0]), np.linspace(-2, 2, shape[1]), indexing="ij")
        arrays = {n: np.zeros(shape) for n in names}
        arrays["phi"] = np.exp(-(xx**2 + yy**2))[:, :, None] * np.ones((1, 1, nk))
        arrays["u"] = np.full(shape, 0.8)
        arrays["v"] = np.full(shape, -0.4)
        arrays["w"] = 0.2 * g.random(shape)
        return arrays

    def make_fields(arrays, backend, device=None):
        kw = {"device": device} if device is not None else {}
        return {n: storage.from_array(a, backend=backend, default_origin=(H, H, 0), **kw) for n, a in arrays.items()}

    def climate_step(st, f, domain):
        st["advect"](f["phi"], f["u"], f["v"], f["adv"], dx=scalars["dx"], dy=scalars["dy"], domain=domain)
        st["euler"](f["phi"], f["adv"], f["phi_star"], dt=scalars["dt"], domain=domain)
        st["diffuse"](f["phi_star"], f["phi_h"], alpha=scalars["alpha"], domain=domain)
        st["vadv_system"](f["w"], f["phi_h"], f["a"], f["b"], f["c"], f["d"],
                          dt=scalars["dt"], dz=scalars["dz"], domain=domain)
        st["vadv"](f["a"], f["b"], f["c"], f["d"], f["phi_new"], domain=domain)
        f["phi"], f["phi_new"] = f["phi_new"], f["phi"]

    cuda_st = {n: S[f"climate.{n}"]["cuda"] for n in climate_defs}
    torch_st = {n: S[f"climate.{n}"]["torch"] for n in climate_defs}
    arrays = climate_arrays(DOMAIN)
    fk = make_fields(arrays, "cuda")
    torch.cuda.synchronize()
    codegen_cuda.reset_launch_counts()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(NSTEPS):
        climate_step(cuda_st, fk, DOMAIN)
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / NSTEPS
    climate_launches = {n: cuda_st[n].launches for n in climate_defs}
    if min(climate_launches.values()) == 0:
        raise AssertionError(f"climate step: a kernel was not launched: {climate_launches}")
    only_these_ran("climate step", climate_launches)
    fp = make_fields(arrays, "torch")
    for _ in range(NSTEPS):
        climate_step(torch_st, fp, DOMAIN)
    torch.cuda.synchronize()
    got, ref = fk["phi"].data, fp["phi"].data
    finite = bool(torch.isfinite(got).all())
    dev_max = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    log(f"path climate_step: {NSTEPS} steps at {DOMAIN} float64, launches {climate_launches}")
    log(f"climate: tracer finite {finite}; max deviation from the torch backend {dev_max:.3e} "
        f"(max |phi| {scale:.3e}, rtol 1e-10); {step_ms:.3f} ms per step (CUDA events); "
        f"{DOMAIN[0] * DOMAIN[1] * DOMAIN[2] / step_ms / 1e3:.1f} Mpts/s; card {card}")
    if not finite or not torch.allclose(got, ref, rtol=1e-10, atol=1e-10 * scale):
        raise AssertionError("climate step: the kernels' tracer differs from the torch backend")
    # the same step on a small domain against the port's numpy backend
    small = (12, 10, 8)
    arrays_s = climate_arrays(small)
    fs_k = make_fields(arrays_s, "cuda")
    fs_n = make_fields(arrays_s, "numpy")
    np_st = {n: gtscript.stencil(backend="numpy")(d) for n, d in climate_defs.items()}
    for _ in range(3):
        climate_step(cuda_st, fs_k, small)
        climate_step(np_st, fs_n, small)
    e = float(np.abs(fs_k["phi"].to_numpy() - fs_n["phi"].to_numpy()).max())
    log(f"climate {small}, 3 steps: max deviation from the numpy backend {e:.3e} (rtol 1e-12)")
    if not np.allclose(fs_k["phi"].to_numpy(), fs_n["phi"].to_numpy(), rtol=1e-12, atol=1e-12):
        raise AssertionError("climate step: the kernels differ from the numpy backend")

    # ---------------------------------------------------------------- 5. times
    def bound(st, domain):
        """(bytes, flops) this call needs: each input region read once, each
        output written once; arithmetic nodes over each stage's region."""
        impl = st.implementation_ir
        ni, nj, nk = domain
        isz = {f.name: np.dtype(f.dtype).itemsize for f in impl.api_fields}
        read_lv, write_lv = {}, {}
        flops = 0
        for ms in impl.multi_stages:
            for itv in ms.intervals:
                k0, k1 = itv.interval.resolve(nk)
                for stage in itv.stages:
                    e = stage.compute_extent
                    pts = (ni + e.i[1] - e.i[0]) * (nj + e.j[1] - e.j[0]) * max(0, k1 - k0)
                    for stmt in stage.stmts:
                        flops += pts * sum(isinstance(x, (ir.BinOp, ir.NativeCall, ir.TernaryOp))
                                           or (isinstance(x, ir.UnaryOp) and x.op == "-")
                                           for x in ir.walk_exprs(stmt))
                        for n, off in ir.stmt_reads(stmt):
                            # an input: read where this call has not written it yet
                            if n in isz and n not in write_lv:
                                read_lv.setdefault(n, set()).update(range(k0 + off[2], k1 + off[2]))
                        for n in ir.stmt_writes(stmt):
                            if n in isz:
                                write_lv.setdefault(n, set()).update(range(k0, k1))
        nbytes = 0
        for n, lv in read_lv.items():
            info = st.field_info[n]
            (ilo, jlo, _), (ihi, jhi, _) = info.halo_lo, info.halo_hi
            nbytes += (ni + ilo + ihi) * (nj + jlo + jhi) * len(lv) * isz[n]
        for n, lv in write_lv.items():
            nbytes += ni * nj * len(lv) * isz[n]
        dtype = impl.api_fields[0].dtype
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
        return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)

    def timed(pair, fields, scalars_, domain):
        launch = pair["cuda"].kernel.prepare(fields, scalars_, domain, {n: (H, H, 0) for n in fields})
        ms = cuda_ms(launch, iters=50)
        plain = cuda_ms(lambda: pair["torch"](**fields, **scalars_, domain=domain, origin=(H, H, 0)), iters=5)
        launch()  # leave the kernel's result in the outputs, for the library check
        return ms, plain

    def library(name, fields, sc, domain):
        """One PyTorch call that computes the stencil, where there is one:
        (ms, max abs difference from the kernel's output), else None."""
        ni, nj, nk = domain
        inner = (slice(H, H + ni), slice(H, H + nj))
        if name == "climate.euler":  # out = phi + dt * adv
            out = torch.empty((ni, nj, nk), dtype=torch.float64, device=dev)
            phi, adv = fields["phi"][inner], fields["adv"][inner]

            def fn():
                return torch.add(phi, adv, alpha=sc["dt"], out=out)
        elif name == "climate.diffuse":  # out = phi + alpha * five-point laplacian(phi), as one convolution
            w = torch.zeros((1, 1, 3, 3, 1), dtype=torch.float64, device=dev)
            w[0, 0, 1, 1, 0] = 1.0 - 4.0 * sc["alpha"]
            w[0, 0, 0, 1, 0] = w[0, 0, 2, 1, 0] = w[0, 0, 1, 0, 0] = w[0, 0, 1, 2, 0] = sc["alpha"]
            x = fields["phi"][H - 1:H + ni + 1, H - 1:H + nj + 1][None, None]

            def fn():
                return torch.nn.functional.conv3d(x, w)[0, 0]
        else:
            return None
        ms = cuda_ms(fn, iters=50)
        return ms, float((fn() - fields["out"][inner]).abs().max())

    report = []
    entries = [
        ("hdiff", "hdiff/float64", "src/repro/kernels/hdiff/ops.py:28", launches["hdiff"]),
        ("vadv", "vadv/float64", "src/repro/kernels/vadv/ops.py:23", launches["vadv"]),
    ] + [
        (f"climate.{n}", f"climate.{n}", "src/repro/core/codegen_pallas.py:123", climate_launches[n])
        for n in climate_defs
    ]
    for name, key, replaces, n_launch in entries:
        pair = S[key]
        fields = field_arrays(pair["cuda"], DOMAIN, "float64")
        if "vadv" in key and "system" not in key:
            diagonally_dominant(fields)
        sc = scal[key.split("/")[0]]
        ms, plain_ms = timed(pair, fields, sc, DOMAIN)
        bound_ms, bound_by, nbytes, flops = bound(pair["cuda"], DOMAIN)
        lib = library(name, fields, sc, DOMAIN)
        lib_text = "no single PyTorch call"
        if lib is not None:
            lib_text = f"library {lib[0]:.4f} ms (max abs diff from the kernel {lib[1]:.3e})"
            if not lib[1] <= 1e-12:
                raise AssertionError(f"{name}: the library call computes another function ({lib[1]:.3e})")
        log(f"time {name:20s} {DOMAIN} float64: kernel {ms:.4f} ms, plain torch {plain_ms:.4f} ms, "
            f"{lib_text}, bound {bound_ms:.4f} ms ({bound_by}: {nbytes / 1e6:.1f} MB, "
            f"{flops / 1e6:.1f} Mflop) -- {card}")
        report.append({
            "name": name, "route": "cuda", "source": "src/repro_torch/core/codegen_cuda.py",
            "replaces": replaces, "launches": n_launch,
            "max_abs_err": err_at_full[key.split("/")[0]], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib[0] if lib else None,
        })
    # the user-facing entry points, end to end: argument checks, hdiff's seeding
    # copy of its input, vadv's scratch, and the launch
    hdiff_entry = cuda_ms(lambda: hdiff_ops.hdiff(x, 0.05), iters=20)
    vadv_entry = cuda_ms(lambda: vadv_ops.vadv(a, b, c, d), iters=20)
    log(f"time entry points {DOMAIN} float64: ops.hdiff {hdiff_entry:.4f} ms, ops.vadv {vadv_entry:.4f} ms "
        f"(CUDA events, each call end to end) -- {card}")
    log(f"card: {card}")
    print(json.dumps({"kernels": report}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
