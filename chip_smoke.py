#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result line:

1. environment: the card's name and power limit, torch, CUDA and nvcc versions;
2. build: every stencil below is generated and compiled with nvcc (sm_90a),
   with the hand-written flash-attention (float32, scores on the float64
   tensor cores: ``flash_fwd.cu``; bfloat16 on the tensor cores:
   ``flash_fwd_sm90.cu``; their ``-Xptxas -v`` registers and spills are
   printed) and RG-LRU sources, all at once, into ``.gt_cache_torch/``; the
   climate step's ``@program`` and its 21-member ``Ensemble`` are compiled
   first on storages of meta tensors, so that their group kernels, the
   groups' member-batched kernels and the 21-member statistics stencil
   build with the rest; so are path G's two programs, built with
   ``autotune=True``, and every candidate block of each of their groups
   (one-member and member-batched: ``core/autotune.py``);
3. kernel vs plain: each generated kernel against the plain torch backend on
   the same CUDA inputs, float64 and float32, at 256 x 256 x 80 and on a
   ragged domain, on fields in the card layout (``storage``) and in C order;
   the hdiff and vadv kernels also against their hand-written oracles
   (``kernels/*/ref.py``), vadv's residual, and the stencil corpus; the
   flash-attention kernels against their plain version, float32 (2e-6) and
   bfloat16 (2e-2), on the reference's kernel-test cases and at the widths of
   phi3-mini-3.8b, stablelm-12b and recurrentgemma-2b, and the bfloat16
   kernel on every head dim, MHA, GQA and MQA, ragged lengths, non-causal,
   window and cap, strided views, decode rows and a row with no key, the
   float32 kernel on every head dim, MHA, GQA 8:32 and MQA, and
   ``scaled_dot_product_attention``'s own float32 error beside the kernel's;
   the RG-LRU kernel at RecurrentGemma-2B's width (4, 4096, 2560), float32
   and bfloat16, bit for bit against the plain loop; the climate program's
   two group kernels against the groups' plain modules, one member and 21
   members at once (u, v and w shared at member stride 0) against the plain
   modules member by member (1e-12);
4. the paths, each with every launch count zeroed just before it and read
   just after: (A) the kernel entry points (``ops.hdiff``, ``ops.vadv``);
   (B) the eager climate step advect → euler → diffuse → vadv_system → vadv
   for 10 steps at 256 x 256 x 80 float64 on ``storage`` fields, held against
   the same step on the torch backend and, on a small domain, the numpy
   backend; (C) LM serving of phi3-mini-3.8b at full width and depth with
   random weights: ``make_cache(4, 2080)``, ``prefill`` of a 4 x 2048 prompt
   through the bfloat16 tensor-core flash kernel (32 launches, none of the
   float32 kernel), 32 greedy ``decode_step``s (no launch), held against the
   same run through the plain ``chunked`` attention in bfloat16 and in
   float32 (the float32 prefill: 32 launches of the float32 kernel); (D)
   ``ops.rglru_scan`` as a user calls it; (E) the climate step as a
   ``@program`` (``stencils/climate.py``): 10 calls, then ``iterate(10)``,
   two launches a step (one per fused group) and none of the five
   per-stencil kernels, held against path B's eager step and the torch
   backend's program (1e-10), iterate against the calls bit for bit; (F)
   ``Ensemble(climate_step, 21).iterate(10)`` from a seeded perturbation
   (member 0 the control), one launch per group and step for all members,
   members 0, 10 and 20 rerun alone through the one-member program bit for
   bit, and the 21-member statistics in one launch against torch's
   reductions; then the autotune sweep: every candidate block of the
   climate program's two groups (and of the forecast step's), timed by the
   tuner on the card at one member and at 16 members, the picked blocks
   held against the groups' plain modules (1e-12) at every member count
   path G serves, and a second build of the program a pure cache hit of
   the tune store; (G) forecast serving: one ``ServingEngine`` on the card
   (``window_ms=2``) holding ``climate_step`` and the reference's serving
   demo ``forecast_step``, both ``autotune=True`` at 256 x 256 x 80
   float64, member counts (1, 2, 4, 8, 16), warmed at ``chunk=5``; 16
   climate requests (one 16-member window) and 5 forecast requests (padded
   to 8) of 10 steps streamed every 5, all submitted at once through
   ``drive_engine``; every request done with no retry, bisect or error,
   climate requests 0, 7 and 15 and the last forecast request equal to
   their runs alone through ``ProgramObject.iterate`` bit for bit;
   requests/s, p50/p99 latency, windows, dispatches, occupancy, dispatch
   seconds and their share of the wall, the host copies (scatter, gather),
   the member-step inside serving against path F's, and the peak of
   device memory;
5. times: every kernel of the paths by CUDA events beside its plain version,
   the one PyTorch call that computes the same function where there is one
   (euler: ``torch.add``; diffuse: ``conv3d``; flash attention:
   ``scaled_dot_product_attention``), and the least time the card could take
   (its bound); the stencils on card-layout fields (what path B runs), once
   more in C order, and once more without the ``cp.async`` prefetch of
   staged planes; ``ops.hdiff`` and ``ops.vadv`` also end to end; the
   float32 flash kernel beside its CUDA-core P·V variant and the
   flash share of the bfloat16 and float32 prefills; RG-LRU in float32 and
   bfloat16; the program step against the eager step, each group kernel
   beside its API-byte bound with its full-scratch bytes and ``SCHEDULE``
   temporaries, each member-batched kernel against the same group for one
   member, the ensemble per step and per member-step, and the statistics
   kernel.

The corpus programs the cuda backend rejects must be exactly those the
reference's Pallas limit rejects.

A ``wall:`` line gives each phase's host time. The line before the last is
the kernels' JSON record; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import asyncio
import dataclasses
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
PEAK_BF16_FLOPS = 989e12  # H100 SXM tensor cores, dense
LM_ARCH, LM_BATCH, LM_PROMPT, LM_STEPS = "phi3-mini-3.8b", 4, 2048, 32
FLASH_TOL = {"float32": 2e-6, "bfloat16": 2e-2}  # the reference's kernel tests
RGLRU_SHAPE = (4, 4096, 2560)  # RecurrentGemma-2B's width, batch 4
RGLRU_TOL = {"float32": 5e-6, "bfloat16": 5e-2}
LM_BF16_REL = 5e-2  # bf16 logits, flash vs chunked: max |diff| <= 5e-2 * max |logit|
TOL = {"float64": (1e-12, 1e-12), "float32": (1e-5, 1e-5)}  # (rtol, atol) kernel vs plain
MEMBERS = 21  # COSMO-E: 20 perturbed members and the control run
ENS_RERUN = (0, 10, 20)  # members rerun alone through the one-member program
SERVE_COUNTS = (1, 2, 4, 8, 16)  # path G: the member counts each served program holds
SERVE_STEPS, SERVE_EVERY = 10, 5  # steps a request, streamed (and warmed) every 5
SERVE_CLIMATE, SERVE_FORECAST = 16, 5  # requests: one full 16-member window, and 5 padded to 8
SERVE_ALONE = (0, 7, 15)  # climate requests rerun alone
SWEEP_MEMBERS = 16


def log(msg: str = "") -> None:
    print(msg, flush=True)


class Walls:
    """Host wall time of the script's phases, each from the end of the last."""

    def __init__(self):
        self.last = time.perf_counter()
        self.parts = []

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.parts.append((name, now - self.last))
        self.last = now

    def line(self) -> str:
        total = sum(t for _n, t in self.parts)
        return "wall: " + ", ".join(f"{n} {t:.1f} s" for n, t in self.parts) + f"; total {total:.1f} s"


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

    from repro_torch.configs import get_arch
    from repro_torch.core import caching, codegen_cuda, gtscript, ir, ir_json, storage
    from repro_torch.core.gtscript import GTScriptSemanticError
    from repro_torch.core.stencil import StencilObject, build_from_definition
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.hdiff import ops as hdiff_ops
    from repro_torch.kernels.hdiff.ref import hdiff_ref
    from repro_torch.kernels.vadv import ops as vadv_ops
    from repro_torch.kernels.rglru import ops as rglru_ops
    from repro_torch.kernels.rglru.ref import rglru_scan_ref
    from repro_torch.kernels.vadv.ref import vadv_ref
    from repro_torch.core import autotune
    from repro_torch.ensemble import Ensemble, batch, perturb
    from repro_torch.models import build_model
    from repro_torch.obs import trace as otrace
    from repro_torch.serving import RequestSpec, ServingEngine, drive_engine
    from repro_torch.stencils import climate, forecast, hdiff, vadv, vintg

    walls = Walls()
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

    walls.mark("start and environment")
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
    climate_defs = climate.DEFINITIONS
    for name, defs in climate_defs.items():
        S[f"climate.{name}"] = {be: build[be](defs) for be in ("cuda", "torch")}

    def without_prefetch(st):
        """``st`` with its staged planes loaded plainly, without the cp.async
        prefetch of the next plane: the kernel the prefetch is timed against."""
        fp = st.fingerprint + "_noprefetch"
        module = caching.load_generated_module(st.name, fp, codegen_cuda.generate_cuda_module_source(
            st.implementation_ir, st.kernel.module.BLOCK, async_staging=False))
        return StencilObject(st.name, "cuda", st.definition_ir, st.implementation_ir, module.CUDA_SOURCE,
                             st._run, fingerprint=fp, module=module,
                             kernel=codegen_cuda.CudaKernel(module, caching.module_key(st.name, fp),
                                                            caching.cache_dir()))

    # the timed kernels that stage planes, without the cp.async prefetch, timed beside
    # them; a kernel with no staged plane is the same kernel either way
    S_sync = {key: without_prefetch(S[key]["cuda"])
              for key in ["hdiff/float64", "vadv/float64"] + [f"climate.{n}" for n in climate_defs]
              if S[key]["cuda"].kernel.module.SCHEDULE["async_staging"]}
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
    # the climate step as a @program (path E) and its 21-member ensemble (path
    # F), compiled now on storages of meta tensors (shapes only) so that their
    # kernels build with the others: one kernel per fused group, one
    # member-batched kernel per group, and the 21-member statistics stencil
    cuda_st = {n: S[f"climate.{n}"]["cuda"] for n in climate_defs}
    torch_st = {n: S[f"climate.{n}"]["torch"] for n in climate_defs}
    full_shape = (DOMAIN[0] + 2 * H, DOMAIN[1] + 2 * H, DOMAIN[2])
    names = climate.FIELD_NAMES
    shared_names = ("u", "v", "w")  # the winds: one copy, read by every member

    def meta_fields(members=None):
        def one(n):
            if members is None or n in shared_names:
                return storage.Storage(torch.empty(full_shape, dtype=torch.float64, device="meta"), "cuda",
                                       (H, H, 0))
            return storage.Storage(torch.empty((members,) + full_shape, dtype=torch.float64, device="meta"),
                                   "cuda", (0, H, H, 0), ("N", "I", "J", "K"))
        return {n: one(n) for n in names}

    scalars = {"dt": 0.1, "dx": 1.0, "dy": 1.0, "dz": 1.0, "alpha": 0.05}
    prog = climate.build_program("cuda", DOMAIN, stencils=cuda_st, name="climate_step")
    prog_cp = prog.compiled(meta_fields(), scalars)
    ens = Ensemble(prog, MEMBERS)
    ens_ce = ens.compiled(meta_fields(MEMBERS), scalars)
    ens_runs = ens_ce.batched_runs({})
    ens_stats = ens.statistics()
    # path G's programs, built with autotune=True (the tuner picks each group's
    # block on the card): the climate step and the reference's serving demo,
    # compiled on meta storages; every candidate block of every group, one
    # member and member-batched (all scalars shared), builds with the rest
    serve_progs = {
        "climate_step": climate.build_program("cuda", DOMAIN, stencils=climate.build_stencils("cuda", autotune=True),
                                              name="climate_step", autotune=True),
        "forecast_step": forecast.build_forecast_step("cuda", DOMAIN, autotune=True),
    }
    fc_shape = (DOMAIN[0] + 2 * forecast.HALO, DOMAIN[1] + 2 * forecast.HALO, DOMAIN[2])
    fc_meta = {n: storage.Storage(torch.empty(fc_shape, dtype=torch.float64, device="meta"), "cuda",
                                  (forecast.HALO, forecast.HALO, 0)) for n in forecast.FIELD_NAMES}
    serve_cps = {"climate_step": serve_progs["climate_step"].compiled(meta_fields(), scalars),
                 "forecast_step": serve_progs["forecast_step"].compiled(fc_meta, dict(forecast.DEFAULT_SCALARS))}
    variants = []
    for cp_ in serve_cps.values():
        for obj in cp_.group_objects:
            # a tune store left by an earlier run in this checkout would hand
            # the sweep that run's timings: clear it, so every block search
            # (and every time the sweep prints) is measured on the card now
            caching.tuning_path(obj.name, obj.fingerprint).unlink(missing_ok=True)
            for blk in autotune.candidate_blocks(obj._module, DOMAIN):
                variants += [obj.block_kernel(blk), obj.block_kernel(blk, ())]
    walls.mark("stencil, program and ensemble generation")
    groups = prog_cp.group_objects
    group_names = ["+".join(n.replace("_defs", "") for n in g) for g in prog_cp.report["group_stencils"]]
    # the hand-written kernels first: the flash sources take longest
    hand = [flash_ops.KERNEL_BF16, flash_ops.KERNEL, rglru_ops.KERNEL]
    kernels = hand + [s["cuda"].kernel for s in list(S.values()) + list(corpus.values())]
    kernels += [s.kernel for s in S_sync.values()]
    kernels += prog_cp.group_kernels + [r.kernel for r in ens_runs] + [ens_stats.stencil.kernel]
    kernels += variants
    for k in kernels:
        k.start_build()
    for k in kernels:
        k.finish_build()
    walls.mark("nvcc")
    log(f"build: {len(S) + len(corpus) + len(S_sync) + 2 * len(groups) + 1} stencils (with the climate "
        f"program's {len(groups)} group kernels, their member-batched variants and the {MEMBERS}-member "
        f"statistics), {len({k.key for k in variants})} block variants of path G's "
        f"{sum(len(c.group_objects) for c in serve_cps.values())} groups and {len(hand)} hand-written kernels, "
        f"{len({k.key for k in kernels})} CUDA sources compiled for sm_90a in {time.perf_counter() - t0:.1f} s "
        f"(corpus programs rejected by the written-API limit: {rejected})")
    for hk in (flash_ops.KERNEL_BF16, flash_ops.KERNEL):
        ptxas = [ln.strip() for ln in hk.library.log.splitlines()
                 if "Used" in ln or "spill" in ln or "Compiling entry" in ln]
        for ln in ptxas or ["(built in an earlier run: no ptxas output)"]:
            log(f"ptxas {hk.key}: {ln}")

    # ---------------------------------------------------------------- 3. kernel vs plain
    rng = np.random.default_rng(2024)

    def field_arrays(st, domain, dtype, layout="card"):
        """Random inputs in the card layout (as ``storage`` makes the cuda
        backend's fields: J contiguous, K slowest) or in C order."""
        shape = (domain[0] + 2 * H, domain[1] + 2 * H, domain[2])
        out = {}
        for n, info in st.field_info.items():
            if info.axes != ("I", "J", "K"):
                raise AssertionError(f"{st.name}: smoke inputs are IJK fields only")
            x = torch.from_numpy(rng.normal(size=shape)).to(dev, getattr(torch, dtype))
            out[n] = storage.card_tensor(shape, x.dtype, dev).copy_(x) if layout == "card" else x
            if storage.is_card_layout(out[n]) != (layout == "card"):
                raise AssertionError(f"{st.name}: field {n!r} is not in the {layout} layout")
        return out

    def diagonally_dominant(fields):
        # |a| + |c| well below b: Thomas is then stable and the kernel's FMAs
        # stay at rounding level against the plain version
        fields["a"] *= 0.1
        fields["c"] *= 0.1
        fields["b"] = fields["b"].abs() + 2.0

    def compare(name, pair, fields, scalars, domain, origin, dtype, layout):
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
        log(f"check {name:28s} {str(domain):16s} {layout:7s} max_abs_err {err:.3e} (rtol {rtol:g}, atol {atol:g}) "
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
            for layout in ("card", "c_order"):
                fields = field_arrays(pair["cuda"], domain, dtype, layout)
                if name in ("vadv", "climate.vadv"):
                    diagonally_dominant(fields)
                e = compare(key, pair, fields, scal[name], domain, (H, H, 0), dtype, layout)
                if domain == DOMAIN and dtype == "float64" and layout == "card":
                    err_at_full[name] = e
    # the kernels without the cp.async prefetch give the same answers
    for key, st in S_sync.items():
        name = key.split("/")[0]
        fields = field_arrays(st, DOMAIN, "float64")
        if name in ("vadv", "climate.vadv"):
            diagonally_dominant(fields)
        compare(key + " (no prefetch)", {"cuda": st, "torch": S[key]["torch"]}, fields, scal[name], DOMAIN,
                (H, H, 0), "float64", "card")

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

    # the hand-written LM kernels against their plain versions (ref.py)
    tgen = torch.Generator(device=dev)

    def normal(shape, dtype, seed):
        tgen.manual_seed(seed)
        return torch.randn(shape, generator=tgen, device=dev, dtype=torch.float32).to(getattr(torch, dtype))

    flash_route = {"float32": (flash_ops.KERNEL, flash_ops.KERNEL_BF16),
                   "bfloat16": (flash_ops.KERNEL_BF16, flash_ops.KERNEL)}

    def check_flash(label, dtype, q_shape, kv_shape, qkv=None, sdpa=False, **kw):
        """The kernel of the dtype's route against the plain version on the
        same inputs: in float64 for float32 inputs (the float32 plain
        version's own rounding of the scores is of the order of the 2e-6
        tolerance at these lengths), in float32 for bfloat16 inputs, as the
        reference's kernel tests.  ``qkv`` replaces the random inputs;
        ``sdpa`` also logs scaled_dot_product_attention's error (float32,
        masks that are only causal or none)."""
        if qkv is None:
            qkv = normal(q_shape, dtype, 1), normal(kv_shape, dtype, 2), normal(kv_shape, dtype, 3)
        q, k, v = qkv
        route, other = flash_route[dtype]
        before, before_other = route.launches, other.launches
        got = flash_ops.flash_attention(q, k, v, **kw)
        work = (lambda x: x.double()) if dtype == "float32" else (lambda x: x)
        ref = flash_attention_ref(work(q), work(k), work(v), **kw)
        torch.cuda.synchronize()
        if route.launches != before + 1 or other.launches != before_other:
            raise AssertionError(f"flash {label} {dtype}: not one launch of {route.key} alone")
        tol = FLASH_TOL[dtype]
        err = float((got.double() - ref.double()).abs().max())
        opts = {n: (int(x) if isinstance(x, torch.Tensor) else x) for n, x in kw.items()}
        log(f"check flash {label:30s} {dtype:8s} q {tuple(q.shape)} kv {tuple(k.shape)} {opts} max_abs_err {err:.3e} "
            f"(rtol {tol:g}, atol {tol:g}; plain version in {'float64' if dtype == 'float32' else 'float32'})")
        if not (torch.isfinite(got).all() and torch.allclose(got.double(), ref.double(), rtol=tol, atol=tol)):
            raise AssertionError(f"flash {label} {dtype}: the kernel differs from the plain version by {err:.3e}")
        if sdpa:
            # what scaled_dot_product_attention's float32 time buys: its own error on the same inputs
            rep_ = q.shape[2] // k.shape[2]
            qt_, kt_, vt_ = (x.transpose(1, 2).repeat_interleave(r, dim=1) for x, r in ((q, 1), (k, rep_), (v, rep_)))
            lib = torch.nn.functional.scaled_dot_product_attention(qt_, kt_, vt_, is_causal=kw["causal"])
            sdpa_err[label] = float((lib.transpose(1, 2).double() - ref.double()).abs().max())
            del qt_, kt_, vt_, lib
            log(f"check flash {label:30s} float32  scaled_dot_product_attention's own max_abs_err "
                f"{sdpa_err[label]:.3e} against the same float64 plain run (the kernel's: {err:.3e})")
        return err

    lm_full = get_arch(LM_ARCH).full
    lm_hd = lm_full.resolved_head_dim
    flash_cases = [  # (label, (B, S, H, Kh, Dh), options)
        ("MHA", (1, 32, 4, 4, 32), {}),
        ("GQA 4:1", (2, 64, 8, 2, 64), {}),
        ("MQA ragged", (1, 48, 6, 1, 128), {}),
        ("Dh 96", (2, 16, 4, 2, 96), {}),
        (f"{LM_ARCH} prefill", (LM_BATCH, LM_PROMPT, lm_full.n_heads, lm_full.n_kv_heads, lm_hd), {}),
        ("stablelm-12b GQA", (1, 2048, 32, 8, 160), {}),
        ("recurrentgemma-2b MQA window", (1, 4096, 10, 1, 256), {"window": 2048}),
    ]
    flash_err, sdpa_err = {}, {}
    for dtype in ("float32", "bfloat16"):
        for label, (b_, s_, h_, kh_, dh_), kw in flash_cases:
            flash_err[(label, dtype)] = check_flash(label, dtype, (b_, s_, h_, dh_), (b_, s_, kh_, dh_),
                                                    sdpa=dtype == "float32" and not kw, causal=True, **kw)
    check_flash("window + cap", "float32", (2, 64, 4, 32), (2, 64, 4, 32), causal=True, window=16, cap=20.0)
    for t in (0, 13, 31):
        pos = torch.tensor(t, dtype=torch.int32, device=dev)
        check_flash(f"decode row t={t}", "float32", (1, 1, 4, 32), (1, 32, 2, 32), causal=True, q_offset=t,
                    kv_len=t + 1)
        check_flash(f"decode row t={t} (device offsets)", "float32", (1, 1, 4, 32), (1, 32, 2, 32), causal=True,
                    q_offset=pos, kv_len=pos + 1)
    # both kernels on every head dim, MHA, GQA and MQA, 300 rows (not a
    # multiple of either kernel's q blocks nor of its kv tiles)
    for dh_ in flash_ops.HEAD_DIMS:
        for label, h_, kh_ in (("MHA", 4, 4), ("GQA", 8, 2), ("MQA", 6, 1)):
            check_flash(f"Dh {dh_} {label}", "bfloat16", (2, 300, h_, dh_), (2, 300, kh_, dh_), causal=True)
        check_flash(f"Dh {dh_} GQA 8:32", "float32", (2, 300, 32, dh_), (2, 300, 8, dh_), causal=True)
        check_flash(f"Dh {dh_} MQA", "float32", (2, 300, 6, dh_), (2, 300, 1, dh_), causal=True)
    qkv = normal((2, 200, 12, 96), "bfloat16", 4)
    views = (qkv[:, :, :4], qkv[:, :, 4:8], qkv[:, :, 8:])  # strided views, head_dim contiguous
    for label, kw in (("non-causal, strided views", {"causal": False}),
                      ("window + cap, strided views", {"causal": True, "window": 37, "cap": 20.0}),
                      ("non-causal window, strided views", {"causal": False, "window": 50})):
        check_flash(label, "bfloat16", None, None, qkv=views, **kw)
    check_flash("77 queries, 200 keys", "bfloat16", None, None, qkv=(views[0][:, :77],) + views[1:], causal=False)
    dec = normal((2, 1, 8, 96), "bfloat16", 5), normal((2, 300, 2, 96), "bfloat16", 6), normal((2, 300, 2, 96), "bfloat16", 7)
    for t in (0, 13, 127, 128, 299):
        pos = torch.tensor(t, dtype=torch.int32, device=dev)
        check_flash(f"decode row t={t}", "bfloat16", None, None, qkv=dec, causal=True, q_offset=t, kv_len=t + 1)
        check_flash(f"decode row t={t} (device offsets)", "bfloat16", None, None, qkv=dec, causal=True,
                    q_offset=pos, kv_len=pos + 1)
    for kw in ({"causal": False, "kv_len": 0}, {"causal": True, "kv_len": torch.tensor(0, dtype=torch.int32, device=dev)}):
        o = flash_ops.flash_attention(normal((1, 130, 4, 96), "bfloat16", 8), dec[1][:1], dec[2][:1], **kw)
        torch.cuda.synchronize()
        if not torch.equal(o, torch.zeros_like(o)):
            raise AssertionError(f"flash bfloat16: rows with no key are not 0 ({kw})")
    log("check flash bfloat16 rows with no key (kv_len 0, host and device): 0 exactly")

    def rglru_inputs(dtype, seed):
        n, _, d = RGLRU_SHAPE
        tgen.manual_seed(seed)
        a_ = 0.5 + 0.499 * torch.rand(RGLRU_SHAPE, generator=tgen, device=dev)
        return (a_.to(getattr(torch, dtype)), normal(RGLRU_SHAPE, dtype, seed + 1),
                normal((n, d), dtype, seed + 2))

    rglru_err = {}
    for dtype in ("float32", "bfloat16"):
        a_rg, x_rg, h_rg = rglru_inputs(dtype, 11)
        got, ref = rglru_ops.rglru_scan(a_rg, x_rg, h_rg), rglru_scan_ref(a_rg, x_rg, h_rg)
        torch.cuda.synchronize()
        tol = RGLRU_TOL[dtype]
        rglru_err[dtype] = float((got.float() - ref.float()).abs().max())
        log(f"check rglru_scan {RGLRU_SHAPE} {dtype:8s} max_abs_err {rglru_err[dtype]:.3e} (rtol {tol:g}, atol {tol:g})")
        if not (torch.isfinite(got).all() and torch.allclose(got.float(), ref.float(), rtol=tol, atol=tol)):
            raise AssertionError(f"rglru_scan {dtype}: the kernel differs from the plain version")
        if not torch.equal(got, ref):  # each update rounded as the plain loop rounds it
            raise AssertionError(f"rglru_scan {dtype}: not the plain loop's bits")
    for dtype in ("float32", "bfloat16"):
        x_rg = normal(RGLRU_SHAPE, dtype, 12)
        if not torch.equal(rglru_ops.rglru_scan(torch.zeros_like(x_rg), x_rg), x_rg):
            raise AssertionError(f"rglru_scan {dtype}: zero decay does not give y == b exactly")
    log("check rglru_scan: the plain loop's bits in float32 and bfloat16; zero decay gives y == b exactly")

    walls.mark("kernels vs plain")
    # the climate program's group kernels, one member and 21 at once, against
    # the groups' plain torch modules (member by member) on the same inputs;
    # the member-by-member plain run is timed here, once, for the times phase
    prog_scalars = prog_cp.runtime_scalars(scalars)

    def group_fields(st, members=None):
        """The group's API fields on the card in the card layout: the climate
        state's winds and w, random phi and phi_star (per member), zeros
        elsewhere; u, v and w shared by the members."""
        out = {}
        for n in st.field_info:
            shape = full_shape if members is None or n in shared_names else (members,) + full_shape
            t = storage.card_tensor(shape, torch.float64, dev)
            tgen.manual_seed(len(out) + 100)
            if n in ("u", "v"):
                t.fill_(0.8 if n == "u" else -0.4)
            elif n == "w":
                t.copy_(0.2 * torch.rand(shape, generator=tgen, device=dev, dtype=torch.float64))
            elif n in ("phi", "phi_star"):
                t.copy_(torch.randn(shape, generator=tgen, device=dev, dtype=torch.float64))
            else:
                t.zero_()
            out[n] = t
        return out

    def member_view(fields, m):
        return {n: (t if n in shared_names else t[m]) for n, t in fields.items()}

    def check_group(gi, members=None):
        obj = groups[gi]
        fields = group_fields(obj, members)
        origins = {n: (H, H, 0) for n in fields}
        got = {n: t.clone() for n, t in fields.items()}
        want = {n: t.clone() for n, t in fields.items()}
        if members is None:
            obj.kernel.prepare(got, prog_scalars, DOMAIN, origins)()
            obj._run(want, prog_scalars, DOMAIN, origins)
        else:
            ens_runs[gi].kernel.prepare(got, prog_scalars, DOMAIN, origins, members=members)()
            # the one-member check ran this module just before: it is warm
            member_plain_ms[gi] = cuda_ms(lambda: [obj._run(member_view(want, m), prog_scalars, DOMAIN, origins)
                                                   for m in range(members)], iters=1, warmup=0)
        torch.cuda.synchronize()
        err = 0.0
        for n in obj.implementation_ir.written_api_fields():
            if not torch.isfinite(got[n]).all():
                raise AssertionError(f"group {group_names[gi]}: non-finite kernel output {n!r}")
            err = max(err, float((got[n] - want[n]).abs().max()))
            if not torch.allclose(got[n], want[n], rtol=1e-12, atol=1e-12):
                raise AssertionError(f"group {group_names[gi]} (members {members}): kernel differs from plain "
                                     f"on {n!r} by {err:.3e}")
        for n in shared_names:
            if n in fields and not torch.equal(got[n], fields[n]):
                raise AssertionError(f"group {group_names[gi]}: the shared field {n!r} changed")
        log(f"check program group {gi} [{group_names[gi]}] {DOMAIN} float64, "
            f"{'one member' if members is None else f'{members} members (shared {sorted(set(shared_names) & set(fields))})'}: "
            f"max_abs_err {err:.3e} against the plain module{'' if members is None else ' member by member'} "
            f"(rtol 1e-12, atol 1e-12)")
        return err

    member_plain_ms = {}
    group_err, member_err = [], []
    for gi in range(len(groups)):
        group_err.append(check_group(gi))
        member_err.append(check_group(gi, MEMBERS))
    walls.mark("program group checks")

    # ---------------------------------------------------------------- 4. the paths
    def ran(counts):
        """The kernels that were launched, with their counts."""
        return {k: n for k, n in counts.items() if n}

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
        climate.eager_step(st, f, domain, scalars)

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

    # path C: LM serving, phi3-mini-3.8b at full width and depth, random weights
    lm_cfg = dataclasses.replace(lm_full, attention_impl="flash")
    lm = build_model(lm_cfg)
    master = lm.init_params(torch.Generator(device=dev).manual_seed(0), device=dev)  # float32
    served = lm.serving_params(master)  # cast once to bfloat16 for serving
    tgen.manual_seed(5)
    prompt = torch.randint(0, lm_cfg.vocab, (LM_BATCH, LM_PROMPT), generator=tgen, device=dev)
    max_len = LM_PROMPT + LM_STEPS
    vocab = lm_cfg.vocab

    def nbytes(params):
        return sum(p.numel() * p.element_size() for p in params.parameters())

    def serve(model, params, forced=None):
        """make_cache → prefill → LM_STEPS decode steps, greedy unless ``forced``
        holds the tokens.  Returns the logits (prefill first), the tokens, the
        prefill and decode seconds (host clock, synchronized) and the launch
        counts of each phase."""
        cache = model.make_cache(LM_BATCH, max_len, device=dev)
        torch.cuda.synchronize()
        codegen_cuda.reset_launch_counts()
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, {"tokens": prompt}, cache)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        pre = dict(codegen_cuda.launch_counts())
        codegen_cuda.reset_launch_counts()
        outs, toks = [logits], []
        t2 = time.perf_counter()
        for i in range(LM_STEPS):
            tok = logits.argmax(dim=-1, keepdim=True) if forced is None else forced[i]
            toks.append(tok)
            logits, cache = model.decode_step(params, {"tokens": tok}, cache)
            outs.append(logits)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        dec = dict(codegen_cuda.launch_counts())
        if int(cache["pos"]) != max_len:
            raise AssertionError(f"serve: cache position {int(cache['pos'])}, expected {max_len}")
        return outs, toks, t1 - t0, t3 - t2, pre, dec

    serve(lm, served)  # warm-up: cuBLAS handles and heuristics, the allocator
    outs_f, toks_f, prefill_s, decode_s, pre_launch, dec_launch = serve(lm, served)
    # bfloat16 prefill: the tensor-core kernel on every layer, and no other kernel
    lm_launches = pre_launch.get(flash_ops.KERNEL_BF16.key, 0)
    if lm_launches != lm_cfg.n_layers or sum(pre_launch.values()) != lm_launches:
        raise AssertionError(f"LM prefill: launches {ran(pre_launch)}, expected {lm_cfg.n_layers} of "
                             f"{flash_ops.KERNEL_BF16.key} only")
    if sum(dec_launch.values()) != 0:
        raise AssertionError(f"LM decode: launches {dec_launch}, expected none (decode attends with naive)")
    cache_gb = 2 * lm_cfg.n_layers * LM_BATCH * max_len * lm_cfg.n_kv_heads * lm_hd * 2 / 1e9
    log(f"path lm_serve: {LM_ARCH} ({lm_cfg.n_layers} layers, d_model {lm_cfg.d_model}, {lm_cfg.n_heads} heads, "
        f"head_dim {lm_hd}) bfloat16, attention_impl=flash, batch {LM_BATCH}, prompt {LM_PROMPT}, "
        f"{LM_STEPS} greedy decode steps; launches: prefill {ran(pre_launch)}, decode {sum(dec_launch.values())}")
    log(f"lm_serve: prefill {prefill_s * 1e3:.1f} ms; decode {decode_s / LM_STEPS * 1e3:.2f} ms per step, "
        f"{LM_BATCH * LM_STEPS / decode_s:.1f} tokens/s; weights {nbytes(master) / 1e9:.2f} GB float32 + "
        f"{nbytes(served) / 1e9:.2f} GB bfloat16 serving copy; KV cache {cache_gb:.2f} GB bfloat16 "
        f"(host clock, synchronized) -- {card}")
    for i, lg in enumerate(outs_f):
        if lg.shape != (LM_BATCH, lm_cfg.padded_vocab) or not torch.isfinite(lg[:, :vocab]).all():
            raise AssertionError(f"LM logits {i}: shape {tuple(lg.shape)} or non-finite values")
    # the same run through the plain chunked attention, teacher-forced with the flash run's tokens
    chunked = build_model(dataclasses.replace(lm_cfg, attention_impl="chunked"))
    outs_c, _, chunked_prefill_s, chunked_decode_s, _, _ = serve(chunked, served, forced=toks_f)
    worst = 0.0
    for i, (a_, b_) in enumerate(zip(outs_f, outs_c)):
        a_, b_ = a_[:, :vocab], b_[:, :vocab]
        rel = float((a_ - b_).abs().max()) / float(b_.abs().max())
        worst = max(worst, rel)
        if not rel <= LM_BF16_REL:
            raise AssertionError(f"LM bfloat16 step {i}: flash vs chunked max |diff| = {rel:.3e} of max |logit|")
    log(f"lm_serve bfloat16: flash vs chunked over prefill + {LM_STEPS} steps, max |diff| {worst:.3e} of "
        f"max |logit| (limit {LM_BF16_REL:g}); chunked prefill {chunked_prefill_s * 1e3:.1f} ms, decode "
        f"{chunked_decode_s / LM_STEPS * 1e3:.2f} ms per step")
    del outs_c, served
    # float32: the same comparison at the reference's smoke-test tolerance
    lm32 = build_model(dataclasses.replace(lm_cfg, dtype="float32"))
    chunked32 = build_model(dataclasses.replace(lm_cfg, dtype="float32", attention_impl="chunked"))
    outs32, toks32, prefill32_s, _, pre32, _ = serve(lm32, master)
    lm32_launches = pre32.get(flash_ops.KERNEL.key, 0)  # float32: the CUDA-core kernel on every layer
    if lm32_launches != lm_cfg.n_layers or sum(pre32.values()) != lm32_launches:
        raise AssertionError(f"LM float32 prefill: launches {ran(pre32)}, expected {lm_cfg.n_layers} of "
                             f"{flash_ops.KERNEL.key} only")
    outs32c, _, _, _, _, _ = serve(chunked32, master, forced=toks32)
    worst32 = 0.0
    for i, (a_, b_) in enumerate(zip(outs32, outs32c)):
        a_, b_ = a_[:, :vocab], b_[:, :vocab]
        worst32 = max(worst32, float((a_ - b_).abs().max()))
        if not (torch.isfinite(a_).all() and torch.allclose(a_, b_, rtol=2e-2, atol=2e-3)):
            raise AssertionError(f"LM float32 step {i}: flash vs chunked differ by {worst32:.3e}")
    log(f"lm_serve float32: flash vs chunked over prefill + {LM_STEPS} steps, max abs diff {worst32:.3e} "
        f"(rtol 2e-2, atol 2e-3); flash prefill {prefill32_s * 1e3:.1f} ms, launches {ran(pre32)}")
    del outs32, outs32c, master

    # path D: ops.rglru_scan as a user calls it
    a_rg, x_rg, h_rg = rglru_inputs("float32", 21)
    torch.cuda.synchronize()
    codegen_cuda.reset_launch_counts()
    y_rg = rglru_ops.rglru_scan(a_rg, x_rg, h_rg)
    torch.cuda.synchronize()
    rglru_launches = rglru_ops.KERNEL.launches
    if rglru_launches != 1 or not torch.isfinite(y_rg).all():
        raise AssertionError(f"rglru entry point: launches {rglru_launches}")
    only_these_ran("rglru entry point", {"rglru_scan": rglru_launches})
    log(f"path rglru: ops.rglru_scan at {RGLRU_SHAPE} float32, launches {rglru_launches}")

    walls.mark("paths A-D")
    # path E: the climate step as a @program, one generated kernel per fused group:
    # 10 calls, then iterate(10) from the same start
    fe_calls, fe_iter = make_fields(arrays, "cuda"), make_fields(arrays, "cuda")
    torch.cuda.synchronize()
    codegen_cuda.reset_launch_counts()
    start.record()
    for _ in range(NSTEPS):
        prog(**fe_calls, **scalars)
    end.record()
    torch.cuda.synchronize()
    prog_ms = start.elapsed_time(end) / NSTEPS
    start.record()
    prog.iterate(NSTEPS, **fe_iter, **scalars)
    end.record()
    torch.cuda.synchronize()
    iter_ms = start.elapsed_time(end) / NSTEPS
    prog_launches = {group_names[gi]: g.launches for gi, g in enumerate(groups)}
    if set(prog_launches.values()) != {2 * NSTEPS} or any(cuda_st[n].launches for n in climate_defs):
        raise AssertionError(f"climate program: launches {prog_launches}, per-stencil "
                             f"{ {n: cuda_st[n].launches for n in climate_defs} }")
    only_these_ran("climate program", prog_launches)
    got = fe_calls["phi"].data
    if not torch.equal(fe_iter["phi"].data, got):
        raise AssertionError("climate program: iterate(10) differs from 10 calls")
    prog_eager_err = float((got - fk["phi"].data).abs().max())
    prog_t = climate.build_program("torch", DOMAIN, stencils=torch_st, name="climate_step_torch")
    ft = make_fields(arrays, "torch")
    for _ in range(NSTEPS):
        prog_t(**ft, **scalars)
    torch.cuda.synchronize()
    prog_torch_err = float((got - ft["phi"].data).abs().max())
    log(f"path climate_program: {NSTEPS} calls and iterate({NSTEPS}) at {DOMAIN} float64, groups "
        f"{prog_cp.report['group_stencils']}, eliminated temporaries {prog_cp.report['eliminated_temporaries']}, "
        f"launches {prog_launches} (the five per-stencil kernels: none)")
    log(f"climate_program: max deviation from path B's eager step {prog_eager_err:.3e}, from the torch backend's "
        f"program {prog_torch_err:.3e} (max |phi| {scale:.3e}, rtol 1e-10); iterate({NSTEPS}) == {NSTEPS} calls "
        f"bit for bit; {prog_ms:.4f} ms per call, {iter_ms:.4f} ms per iterated step (CUDA events); card {card}")
    for other in (fk["phi"].data, ft["phi"].data):
        if not (torch.isfinite(got).all() and torch.allclose(got, other, rtol=1e-10, atol=1e-10 * scale)):
            raise AssertionError("climate program: differs from the eager step or from the torch program")
    del ft, prog_t

    walls.mark("path E")
    # path F: Ensemble(climate_step, 21).iterate(10): phi perturbed (member 0 the
    # control), u, v and w shared, one launch per group and step for all members
    base = make_fields(arrays, "cuda")
    ef = {n: (perturb(base["phi"], MEMBERS, seed=0, amplitude=1e-3, perturb_member0=False) if n == "phi"
              else base[n] if n in shared_names
              else batch.zeros(MEMBERS, full_shape, backend="cuda", default_origin=(H, H, 0)))
          for n in names}
    if not torch.equal(ef["phi"].data[0], base["phi"].data):
        raise AssertionError("ensemble: the control member is perturbed")
    init = {m: ef["phi"].data[m].clone() for m in ENS_RERUN}
    ens_gb = sum(f.data.numel() * 8 for n, f in ef.items() if n not in shared_names) / 1e9
    torch.cuda.synchronize()
    codegen_cuda.reset_launch_counts()
    start.record()
    ens.iterate(NSTEPS, **ef, **scalars)
    end.record()
    torch.cuda.synchronize()
    ens_ms = start.elapsed_time(end) / NSTEPS
    ens_launches = {group_names[gi]: r.kernel.launches for gi, r in enumerate(ens_runs)}
    if set(ens_launches.values()) != {NSTEPS}:
        raise AssertionError(f"ensemble: launches {ens_launches}, expected {NSTEPS} a group")
    only_these_ran("ensemble", ens_launches)
    ens_scratch_gb = sum(r.kernel.scratch_bytes(DOMAIN, MEMBERS) for r in ens_runs) / 1e9
    if not torch.isfinite(ef["phi"].data).all():
        raise AssertionError("ensemble: non-finite members")
    for m in ENS_RERUN:  # each member alone through the one-member program
        one = make_fields(arrays, "cuda")
        one["phi"].data.copy_(init[m])
        prog.iterate(NSTEPS, **one, **scalars)
        torch.cuda.synchronize()
        if not torch.equal(one["phi"].data, ef["phi"].data[m]):
            err = float((one["phi"].data - ef["phi"].data[m]).abs().max())
            raise AssertionError(f"ensemble member {m}: differs from the member run alone by {err:.3e}")
    if not torch.equal(ef["phi"].data[0], fe_iter["phi"].data):
        raise AssertionError("ensemble: the control member differs from path E")
    spread = float((ef["phi"].data - ef["phi"].data[0]).abs().max())
    log(f"path ensemble: Ensemble(climate_step, {MEMBERS}).iterate({NSTEPS}) at {DOMAIN} float64, shared "
        f"{list(shared_names)}, launches {ens_launches} (one a group and step for all {MEMBERS} members); "
        f"batched fields {ens_gb:.2f} GB, member-batched scratch {ens_scratch_gb:.2f} GB")
    log(f"ensemble: members {list(ENS_RERUN)} rerun alone through the one-member program: bit-identical; "
        f"the control member equals path E bit for bit; max |member - control| {spread:.3e}; "
        f"{ens_ms:.4f} ms per step, {ens_ms / MEMBERS:.4f} ms per member-step (CUDA events), against "
        f"{iter_ms:.4f} ms for the one-member step; card {card}")
    # the 21-member statistics: one launch, against the same reductions in torch
    codegen_cuda.reset_launch_counts()
    stats_out = ens_stats(ef["phi"], threshold=0.5)
    torch.cuda.synchronize()
    stats_launches = ens_stats.stencil.launches
    if stats_launches != 1:
        raise AssertionError(f"ensemble statistics: {stats_launches} launches")
    only_these_ran("ensemble statistics", {"stats": stats_launches})
    xm = ef["phi"].data
    oracle = {"mean": xm.mean(0), "var": xm.var(0, unbiased=False), "spread": xm.var(0, unbiased=False).sqrt(),
              "mn": xm.amin(0), "mx": xm.amax(0), "prob": (xm > 0.5).double().mean(0)}
    stats_err = max(float((stats_out[n].data - oracle[n]).abs().max()) for n in oracle)
    log(f"path ensemble statistics: {MEMBERS} members at {full_shape} float64 (halo included), launches "
        f"{stats_launches}; max_abs_err {stats_err:.3e} against torch's reductions (atol 1e-12)")
    if not stats_err <= 1e-12:
        raise AssertionError(f"ensemble statistics differ from torch's reductions by {stats_err:.3e}")
    del oracle, base, one

    walls.mark("path F")
    # ---------------------------------------------------------------- the autotune sweep and path G
    # one engine on the card holding both autotuned programs at the climate
    # tile's full size; registration warms every member count at chunk=5,
    # which tunes each member-batched group's block for its batched shapes
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tracer = otrace.Tracer(enabled=True)
    engine = ServingEngine(window_ms=2.0, tracer=tracer)
    serve_fields = {"climate_step": make_fields(arrays, "cuda"),
                    "forecast_step": forecast.make_forecast_fields("cuda", DOMAIN)[0]}
    serve_scalars = {"climate_step": dict(scalars), "forecast_step": dict(forecast.DEFAULT_SCALARS)}
    serve_shared = {"climate_step": ("u", "v", "w"), "forecast_step": ("u", "v")}
    t0 = time.perf_counter()
    entries = {pname: engine.register(sprog, fields=serve_fields[pname], scalars=serve_scalars[pname],
                                      request_fields=("phi",), member_counts=SERVE_COUNTS, warm=True,
                                      warm_chunk=SERVE_EVERY)
               for pname, sprog in serve_progs.items()}
    torch.cuda.synchronize()
    log(f"path serving: registered {list(entries)} at {DOMAIN} float64 with autotune=True, member counts "
        f"{list(SERVE_COUNTS)}, warmed at chunk={SERVE_EVERY} (block searches included) in "
        f"{time.perf_counter() - t0:.1f} s; shared fields {serve_shared}")

    def served_runs(entry, m):
        """The group runs the engine's m-member ensemble launches (every
        scalar shared): looked up with meta storages of the batched shapes."""
        meta = {}
        for n in entry.prog.field_params:
            t = entry.fields[n]
            meta[n] = t if n not in entry.batched_fields else storage.Storage(
                torch.empty((m,) + tuple(t.shape), dtype=t.data.dtype, device="meta"), "cuda",
                (0,) + tuple(t.default_origin), ("N",) + tuple(t.axes))
        return entry.ensembles[m].compiled(meta, entry.scalars).batched_runs({})

    def serving_fields(obj, shape, shared, members=None):
        """Random inputs for a group of a served program, on the card in the
        card layout: winds of random sign point by point (so every upwind
        select takes both branches at every tile edge, and each block's staged
        halo is read on all four sides), w small, phi and phi_star random,
        zeros elsewhere; the shared fields without a member axis."""
        out = {}
        for n in obj.field_info:
            shp = shape if members is None or n in shared else (members,) + shape
            t = storage.card_tensor(shp, torch.float64, dev)
            tgen.manual_seed(len(out) + 300)
            if n in ("u", "v"):
                t.copy_(0.8 * torch.randn(shp, generator=tgen, device=dev, dtype=torch.float64))
            elif n == "w":
                t.copy_(0.2 * torch.rand(shp, generator=tgen, device=dev, dtype=torch.float64))
            elif n in ("phi", "phi_star"):
                t.copy_(torch.randn(shp, generator=tgen, device=dev, dtype=torch.float64))
            else:
                t.zero_()
            out[n] = t
        return out

    def check_tuned(pname, gi, obj, kernel, members):
        """The tuned kernel against the group's plain module (member by member
        when batched; ``members`` 0: the one-member program's kernel, no
        member axis) on the same inputs, 1e-12; returns (max abs err, kernel
        ms, plain ms)."""
        entry = entries[pname]
        shape = tuple(entry.fields["phi"].shape)
        shared = serve_shared[pname]
        sc = entry.cp.runtime_scalars(entry.scalars)
        fields = serving_fields(obj, shape, shared, members or None)
        origins = {n: tuple(entry.fields[n].default_origin) for n in fields}
        got = {n: t.clone() for n, t in fields.items()}
        want = {n: t.clone() for n, t in fields.items()}
        launch = kernel.prepare(got, sc, DOMAIN, origins, members=members or None)
        launch()
        if not members:
            plain = lambda: obj._run(want, sc, DOMAIN, origins)  # noqa: E731
        else:
            plain = lambda: [obj._run({n: (t if n in shared else t[m]) for n, t in want.items()}, sc, DOMAIN,  # noqa: E731
                                      origins) for m in range(members)]
        plain_ms = cuda_ms(plain, iters=1, warmup=0)
        torch.cuda.synchronize()
        err = 0.0
        for n in obj.implementation_ir.written_api_fields():
            if not torch.isfinite(got[n]).all():
                raise AssertionError(f"{pname} group {gi}: non-finite tuned-kernel output {n!r}")
            err = max(err, float((got[n] - want[n]).abs().max()))
            if not torch.allclose(got[n], want[n], rtol=1e-12, atol=1e-12):
                raise AssertionError(f"{pname} group {gi} block {kernel.module.BLOCK} ({members} members): the "
                                     f"tuned kernel differs from the plain module on {n!r} by {err:.3e}")
        ms = cuda_ms(launch, iters=3)
        del fields, got, want, launch
        return err, ms, plain_ms

    # the sweep: every candidate's card time at one member (the one-member
    # program's groups, which the runs alone below launch) and at 16 members
    # (the served 16-member ensemble's groups), as the tuner measured them
    serve_gnames = {pname: ["+".join(n.replace("_defs", "") for n in g) for g in e.cp.report["group_stencils"]]
                    for pname, e in entries.items()}
    tuned = {}  # (program, group, members; 0: the one-member program) -> (block, record, kernel)
    for pname, entry in entries.items():
        one_kernels = entry.cp.group_kernels  # resolves (tunes) the one-member groups' blocks
        for gi, obj in enumerate(entry.cp.group_objects):
            blk, rec = obj._resolve_block(DOMAIN)
            tuned[(pname, gi, 0)] = (tuple(blk), rec, one_kernels[gi])
        for m in SERVE_COUNTS:
            for gi, r in enumerate(served_runs(entry, m)):
                kern = r.kernel
                tuned[(pname, gi, m)] = (tuple(kern.module.BLOCK), r.autotune, kern)
        for gi, obj in enumerate(entry.cp.group_objects):
            b1, rec1, _k = tuned[(pname, gi, 0)]
            b16, rec16, _k = tuned[(pname, gi, SWEEP_MEMBERS)]
            t1 = {tuple(t["block"]): t["us"] / 1e3 for t in rec1["timings"]}
            t16 = {tuple(t["block"]): t["us"] / 1e3 for t in rec16["timings"]}
            for blk in sorted(set(t1) | set(t16)):
                a_ = f"{t1[blk]:.4f} ms" if blk in t1 else "not a candidate"
                b_ = (f"{t16[blk]:.4f} ms ({t16[blk] / SWEEP_MEMBERS:.4f} a member)" if blk in t16
                      else "not a candidate")
                mark = "".join([" <- picked at 1 member" if blk == b1 else "",
                                f" <- picked at {SWEEP_MEMBERS} members" if blk == b16 else ""])
                log(f"sweep {pname} group {gi} [{serve_gnames[pname][gi]}] {DOMAIN} float64 block {blk}: "
                    f"1 member {a_}, {SWEEP_MEMBERS} members {b_}{mark}")
            best1, best16 = min(t1.values()), min(t16.values())
            default1 = t1.get(tuple(codegen_cuda.DEFAULT_BLOCK))
            log(f"sweep {pname} group {gi}: best one-member block {b1} {best1:.4f} ms (default "
                f"{codegen_cuda.DEFAULT_BLOCK} {default1:.4f} ms); best {SWEEP_MEMBERS}-member block {b16} "
                f"{best16 / SWEEP_MEMBERS:.4f} ms a member, {best16 / SWEEP_MEMBERS / best1:.3f}x the best "
                f"one-member time (CUDA events, best of the tuner's iterations) -- {card}")
            log(f"sweep {pname} group {gi}: tune store {caching.tuning_path(obj.name, obj.fingerprint)}")
        for m in SERVE_COUNTS:
            log(f"sweep {pname}: blocks picked at {m} members: "
                f"{[tuned[(pname, gi, m)][0] for gi in range(len(entry.cp.group_objects))]}"
                f" (searched on the card in this run; the store was cleared at the build)")
    # every block the tuner picked, as launched, against the plain module
    tuned_check = {}
    for (pname, gi, m), (blk, _rec, kern) in sorted(tuned.items()):
        obj = entries[pname].cp.group_objects[gi]
        tuned_check[(pname, gi, m)] = check_tuned(pname, gi, obj, kern, m)
        log(f"check tuned {pname} group {gi} [{serve_gnames[pname][gi]}] block {blk} "
            f"{'one-member program' if m == 0 else f'{m}-member ensemble'}: max_abs_err "
            f"{tuned_check[(pname, gi, m)][0]:.3e} against the plain module"
            f"{'' if m == 0 else ' member by member'} (rtol 1e-12, atol 1e-12)")
    # a second build of the identical program: a pure cache hit of the tune store on disk
    autotune._memory.clear()
    again = climate.build_program("cuda", DOMAIN, stencils=climate.build_stencils("cuda", autotune=True),
                                  name="climate_step", autotune=True).compiled(meta_fields(), scalars)
    for gi, obj in enumerate(again.group_objects):
        blk, rec = obj._resolve_block(DOMAIN)
        if rec["cache_hit"] is not True or tuple(blk) != tuned[("climate_step", gi, 0)][0]:
            raise AssertionError(f"climate program rebuilt: group {gi} record {rec.get('cache_hit')}, block {blk}")
        log(f"sweep climate_step group {gi}: second build of the identical program, cache_hit: "
            f"{rec['cache_hit']}, block {tuple(blk)} (store {caching.tuning_path(obj.name, obj.fingerprint)})")
    del again
    walls.mark("autotune sweep and tuned-kernel checks")

    # path G: the load, all requests submitted at once
    def climate_request(seed):
        """A per-request initial phi for the climate program: the blob and
        a seeded perturbation, shaped like the template."""
        return arrays["phi"] + 1e-3 * np.random.default_rng(seed).normal(size=arrays["phi"].shape)

    specs = [RequestSpec("climate_step", {"phi": climate_request(i + 1)}, steps=SERVE_STEPS,
                         stream_every=SERVE_EVERY) for i in range(SERVE_CLIMATE)]
    specs += [RequestSpec("forecast_step", {"phi": forecast.request_state(DOMAIN, seed=i + 1)}, steps=SERVE_STEPS,
                          stream_every=SERVE_EVERY) for i in range(SERVE_FORECAST)]

    async def serve_load():
        async with engine:
            return await drive_engine(engine, specs)

    torch.cuda.synchronize()
    tracer.clear()
    codegen_cuda.reset_launch_counts()
    load = asyncio.run(serve_load())
    torch.cuda.synchronize()
    # the served kernels: one per group and picked block (member counts that
    # picked the same block share it); the member count each program's
    # windows ran at, from the requests' done events
    served = {}
    for pname, entry in entries.items():
        for m in SERVE_COUNTS:
            for r in served_runs(entry, m):
                served[id(r.kernel)] = r.kernel
    only_these_ran("forecast serving", {f"{k.key}#{i}": k.launches for i, k in enumerate(served.values())})
    served_m = {pname: sorted({r.members for r, sp in zip(load.results, specs) if sp.program == pname})
                for pname in entries}
    serve_launches = {(pname, gi, m): tuned[(pname, gi, m)][2].launches for pname, ms in served_m.items()
                      for m in ms for gi in range(len(entries[pname].cp.group_objects))}
    stats = engine.stats()
    bad = [r.request_id for r in load.results if not r.ok or r.steps_seen != list(range(SERVE_EVERY, SERVE_STEPS + 1,
                                                                                        SERVE_EVERY))]
    if bad or stats["errors"] or stats["retries"] or stats["bisects"]:
        raise AssertionError(f"serving: requests not done {bad}; errors {stats['errors']}, retries "
                             f"{stats['retries']}, bisects {stats['bisects']}")
    if min(serve_launches.values()) == 0 or sum(serve_launches.values()) != sum(
            k.launches for k in served.values()):
        raise AssertionError(f"serving: launches {serve_launches}, windows at {served_m} members")
    spans = tracer.snapshot()
    span_s = {k: sum(sp["end_s"] - sp["start_s"] for sp in spans if sp["name"] == f"serving.{k}")
              for k in ("scatter", "gather", "dispatch")}
    dispatch_s = {pname: e.hist["dispatch"].sum for pname, e in entries.items()}
    padded = {pname: stats["per_program"][pname]["padded_members"] for pname in entries}
    member_step_ms = {pname: dispatch_s[pname] / (SERVE_STEPS * padded[pname]) * 1e3 for pname in entries}
    field_mb = {pname: e.fields["phi"].data.numel() * 8 / 1e6 for pname, e in entries.items()}
    scatter_mb = sum(field_mb[p] * padded[p] for p in entries)
    gather_mb = sum(field_mb[sp_.program] * (SERVE_STEPS // SERVE_EVERY) for sp_ in specs)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"path serving: {len(specs)} requests ({SERVE_CLIMATE} climate_step, {SERVE_FORECAST} forecast_step) x "
        f"{SERVE_STEPS} steps, streamed every {SERVE_EVERY}, at {DOMAIN} float64; launches "
        f"{ {f'{p}.{serve_gnames[p][g]}@{m}': n for (p, g, m), n in serve_launches.items()} }")
    log(f"serving: {load.requests_per_second:.2f} requests/s, p50 {load.p50_ms:.1f} ms, p99 {load.p99_ms:.1f} ms "
        f"(host clock, submit to done), wall {load.wall_s:.3f} s; windows {stats['batches']}, dispatches "
        f"{stats['dispatches']}, member occupancy {stats['mean_occupancy']:.3f} "
        f"({ {p: round(v['live_members'] / max(1, v['padded_members']), 3) for p, v in stats['per_program'].items()} }); "
        f"retries {stats['retries']}, bisects {stats['bisects']}, errors {stats['errors']} -- {card}")
    log(f"serving: dispatch seconds {dispatch_s} (sum {sum(dispatch_s.values()):.4f} s, "
        f"{sum(dispatch_s.values()) / load.wall_s:.3f} of the load's wall; the two programs' dispatches may "
        f"overlap); host copies: scatter {span_s['scatter']:.4f} s ({scatter_mb:.0f} MB to the card, pageable), "
        f"gather {span_s['gather']:.4f} s ({gather_mb:.0f} MB to the host, card layout transposed on the host) "
        f"-- {card}")
    log(f"serving: member-step inside serving {member_step_ms} ms (dispatch seconds over steps x padded members), "
        f"against path F's bare Ensemble.iterate member-step {ens_ms / MEMBERS:.4f} ms ({MEMBERS} members); "
        f"peak device memory {peak_gb:.2f} GB (torch.cuda.max_memory_allocated) -- {card}")
    # the runs alone: climate requests 0, 7 and 15 and the last forecast
    # request, each from its own state through ProgramObject.iterate
    by_id = {r.request_id: r for r in load.results}
    for idx in SERVE_ALONE + (SERVE_CLIMATE + SERVE_FORECAST - 1,):
        spec, res = specs[idx], by_id[f"load-{idx}"]
        pname = spec.program
        one = {n: storage.Storage(s_.data.clone(), "cuda", s_.default_origin, s_.axes)
               for n, s_ in serve_fields[pname].items()}
        one["phi"].data.copy_(torch.from_numpy(spec.fields["phi"]))
        for t in range(SERVE_EVERY, SERVE_STEPS + 1, SERVE_EVERY):
            serve_progs[pname].iterate(SERVE_EVERY, **one, **serve_scalars[pname])
            alone = one["phi"].to_numpy()
            if not np.array_equal(res.step_fields[t]["phi"], alone):
                err = float(np.abs(res.step_fields[t]["phi"] - alone).max())
                raise AssertionError(f"serving: request {idx} ({pname}) at step {t} differs from its run alone "
                                     f"by {err:.3e}")
        if not np.isfinite(res.step_fields[SERVE_STEPS]["phi"]).all():
            raise AssertionError(f"serving: request {idx} streamed non-finite values")
        del one
    log(f"serving: climate_step requests {list(SERVE_ALONE)} and forecast_step request "
        f"{SERVE_CLIMATE + SERVE_FORECAST - 1} (padded to {by_id[f'load-{SERVE_CLIMATE + SERVE_FORECAST - 1}'].members} "
        f"members) equal their runs alone through ProgramObject.iterate bit for bit at every streamed step")
    serve_objs = {pname: list(e.cp.group_objects) for pname, e in entries.items()}
    del load, by_id, engine, entries, serve_fields
    walls.mark("path G")
    # ---------------------------------------------------------------- 5. times
    def bound(st, domain, members=1, shared=()):
        """(bytes, flops) this call needs: each input region read once, each
        output written once; arithmetic nodes over each stage's region; a
        member-batched call reads and writes each member's fields, the
        ``shared`` ones once."""
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
            nbytes += (ni + ilo + ihi) * (nj + jlo + jhi) * len(lv) * isz[n] * (1 if n in shared else members)
        for n, lv in write_lv.items():
            nbytes += ni * nj * len(lv) * isz[n] * members
        flops *= members
        dtype = impl.api_fields[0].dtype
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
        return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)

    def timed(st, fields, scalars_, domain):
        """The kernel's ms a launch, arguments prepared once; its result is
        left in the outputs, for the library check."""
        launch = st.kernel.prepare(fields, scalars_, domain, {n: (H, H, 0) for n in fields})
        ms = cuda_ms(launch, iters=50)
        launch()
        return ms

    def library(name, fields, sc, domain):
        """One PyTorch call that computes the stencil, where there is one:
        (ms, max abs difference from the kernel's output), else None."""
        ni, nj, nk = domain
        inner = (slice(H, H + ni), slice(H, H + nj))
        if name == "climate.euler":  # out = phi + dt * adv, in the inputs' layout
            phi, adv = fields["phi"][inner], fields["adv"][inner]
            out = torch.empty_like(phi)
            if storage.is_card_layout(out) != storage.is_card_layout(fields["phi"]):
                raise AssertionError("euler yardstick: out is not in the inputs' layout")

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
        sc = scal[key.split("/")[0]]
        by_layout = {}
        for layout in ("c_order", "card"):  # card last: its outputs feed the library check
            fields = field_arrays(pair["cuda"], DOMAIN, "float64", layout)
            if "vadv" in key and "system" not in key:
                diagonally_dominant(fields)
            by_layout[layout] = timed(pair["cuda"], fields, sc, DOMAIN)
        ms = by_layout["card"]  # what path B runs: storage fields in the card layout
        # the same fields through the kernel without the cp.async prefetch of staged planes
        ms_sync = timed(S_sync.get(key, pair["cuda"]), fields, sc, DOMAIN)
        plain_ms = cuda_ms(lambda: pair["torch"](**fields, **sc, domain=DOMAIN, origin=(H, H, 0)), iters=5)
        timed(pair["cuda"], fields, sc, DOMAIN)  # the kernel's result in the outputs again
        bound_ms, bound_by, nbytes, flops = bound(pair["cuda"], DOMAIN)
        lib = library(name, fields, sc, DOMAIN)
        lib_text = "no single PyTorch call"
        if lib is not None:
            lib_text = f"library {lib[0]:.4f} ms on the same layout (max abs diff from the kernel {lib[1]:.3e})"
            if not lib[1] <= 1e-12:
                raise AssertionError(f"{name}: the library call computes another function ({lib[1]:.3e})")
        staged = pair["cuda"].kernel.module.SCHEDULE["async_staging"]
        log(f"time {name:20s} {DOMAIN} float64: kernel {ms:.4f} ms on card-layout fields, "
            f"{by_layout['c_order']:.4f} ms on C-order fields, {ms_sync:.4f} ms without the cp.async prefetch"
            f"{'' if staged else ' (no staged plane: the same kernel)'}; plain torch {plain_ms:.4f} ms, "
            f"{lib_text}, bound {bound_ms:.4f} ms ({bound_by}: {nbytes / 1e6:.1f} MB, "
            f"{flops / 1e6:.1f} Mflop) -- {card}")
        report.append({
            "name": name, "route": "cuda", "source": "src/repro_torch/core/codegen_cuda.py",
            "replaces": replaces, "launches": n_launch,
            "max_abs_err": err_at_full[key.split("/")[0]], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib[0] if lib else None,
            "ms_c_order": by_layout["c_order"], "ms_no_prefetch": ms_sync,
        })
    # the climate program's group kernels (path E) and their member-batched
    # variants (path F), arguments prepared once; the program step, the ensemble
    log(f"time climate step {DOMAIN} float64: program {prog_ms:.4f} ms per call ({len(groups)} launches), "
        f"{iter_ms:.4f} ms per iterated step, against the eager step's {step_ms:.4f} ms (5 launches) -- {card}")
    for gi, obj in enumerate(groups):
        origins = {n: (H, H, 0) for n in obj.field_info}
        fields = group_fields(obj)
        ms = cuda_ms(obj.kernel.prepare(fields, prog_scalars, DOMAIN, origins), iters=50)
        plain_ms = cuda_ms(lambda: obj._run(fields, prog_scalars, DOMAIN, origins), iters=3)
        bound_ms, bound_by, nbytes, flops = bound(obj, DOMAIN)
        scratch = obj.kernel.scratch_bytes(DOMAIN)
        temps = obj.kernel.module.SCHEDULE["temporaries"]
        log(f"time program group {gi} [{group_names[gi]}] {DOMAIN} float64: kernel {ms:.4f} ms, plain torch "
            f"{plain_ms:.4f} ms, no single PyTorch call, bound {bound_ms:.4f} ms ({bound_by}: API fields "
            f"{nbytes / 1e6:.1f} MB, {flops / 1e6:.1f} Mflop); full-scratch temporaries "
            f"{scratch / 1e6:.1f} MB written and read back -- {card}")
        log(f"schedule program group {gi} [{group_names[gi]}]: temporaries {temps}; staged "
            f"{obj.kernel.module.SCHEDULE['staged_inputs']}")
        report.append({
            "name": f"climate_program.{group_names[gi]}", "route": "cuda",
            "source": "src/repro_torch/core/codegen_cuda.py", "replaces": "src/repro/core/codegen_pallas.py:123",
            "launches": prog_launches[group_names[gi]], "max_abs_err": group_err[gi], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "scratch_bytes": scratch, "full_temporaries": sorted(n for n, k in temps.items() if k == "full"),
        })
        del fields
        fields = group_fields(obj, MEMBERS)
        ms_m = cuda_ms(ens_runs[gi].kernel.prepare(fields, prog_scalars, DOMAIN, origins, members=MEMBERS),
                       iters=5)
        plain_m = member_plain_ms[gi]
        bound_m, by_m, nbytes_m, flops_m = bound(obj, DOMAIN, MEMBERS, shared_names)
        scratch_m = ens_runs[gi].kernel.scratch_bytes(DOMAIN, MEMBERS)
        log(f"time member-batched group {gi} [{group_names[gi]}] {MEMBERS} x {DOMAIN} float64: kernel {ms_m:.4f} ms "
            f"({ms_m / MEMBERS:.4f} ms a member, against {ms:.4f} ms for one member alone), plain torch member by "
            f"member {plain_m:.4f} ms, bound {bound_m:.4f} ms ({by_m}: {nbytes_m / 1e6:.1f} MB); full-scratch "
            f"temporaries {scratch_m / 1e9:.2f} GB -- {card}")
        report.append({
            "name": f"climate_ensemble.{group_names[gi]}", "route": "cuda",
            "source": "src/repro_torch/core/codegen_cuda.py", "replaces": "src/repro/core/codegen_pallas.py:123",
            "launches": ens_launches[group_names[gi]], "max_abs_err": member_err[gi], "ms": ms_m,
            "plain_ms": plain_m, "bound_ms": bound_m, "bound_by": by_m, "library_ms": None,
            "members": MEMBERS, "scratch_bytes": scratch_m,
        })
        del fields
    log(f"time ensemble {MEMBERS} members {DOMAIN} float64: {ens_ms:.4f} ms per step "
        f"({ens_ms / MEMBERS:.4f} ms per member-step) against the one-member program's {iter_ms:.4f} ms per "
        f"step ({ens_ms / MEMBERS / iter_ms:.3f}x) -- {card}")
    st_fields = {f"m{i}": ef["phi"].data[i] for i in range(MEMBERS)}
    st_fields.update({n: t.data for n, t in stats_out.items()})
    st_origins = {n: (0, 0, 0) for n in st_fields}
    thr = {"threshold": 0.5}
    stats_ms = cuda_ms(ens_stats.stencil.kernel.prepare(st_fields, thr, full_shape, st_origins), iters=20)
    stats_plain = cuda_ms(lambda: ens_stats.stencil._run(st_fields, thr, full_shape, st_origins), iters=3)
    stats_bound, stats_by, stats_bytes, _ = bound(ens_stats.stencil, full_shape)
    log(f"time ensemble statistics {MEMBERS} members {full_shape} float64: kernel {stats_ms:.4f} ms, plain torch "
        f"{stats_plain:.4f} ms, no single PyTorch call, bound {stats_bound:.4f} ms ({stats_by}: "
        f"{stats_bytes / 1e6:.1f} MB) -- {card}")
    report.append({
        "name": "ensemble_stats", "route": "cuda", "source": "src/repro_torch/core/codegen_cuda.py",
        "replaces": "src/repro/core/codegen_pallas.py:123", "launches": stats_launches, "max_abs_err": stats_err,
        "ms": stats_ms, "plain_ms": stats_plain, "bound_ms": stats_bound, "bound_by": stats_by,
        "library_ms": None, "members": MEMBERS,
    })
    del ef, st_fields, stats_out, xm
    # path G's kernels: each served group's tuned member-batched kernel at the
    # member count the load launched it at (times from the tuned-kernel checks)
    for (pname, gi, m), n_launch in sorted(serve_launches.items()):
        obj = serve_objs[pname][gi]
        blk, rec, _k = tuned[(pname, gi, m)]
        err, ms, plain_ms = tuned_check[(pname, gi, m)]
        bound_ms, bound_by, nbytes, _fl = bound(obj, DOMAIN, m, serve_shared[pname])
        log(f"time serving {pname} group {gi} [{serve_gnames[pname][gi]}] {m} x {DOMAIN} float64, tuned block "
            f"{blk}: kernel {ms:.4f} ms ({ms / m:.4f} ms a member), plain torch member by member {plain_ms:.4f} ms, "
            f"no single PyTorch call, bound {bound_ms:.4f} ms ({bound_by}: {nbytes / 1e6:.1f} MB); launches "
            f"{n_launch} -- {card}")
        report.append({
            "name": f"serving.{pname}.{serve_gnames[pname][gi]}", "route": "cuda",
            "source": "src/repro_torch/core/codegen_cuda.py", "replaces": "src/repro/core/codegen_pallas.py:123",
            "launches": n_launch, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None, "members": m, "block": list(blk),
            "tuned_us": {f"{t['block'][0]}x{t['block'][1]}": t["us"] for t in rec["timings"]},
            "one_member_block": list(tuned[(pname, gi, 0)][0]),
            "one_member_max_abs_err": tuned_check[(pname, gi, 0)][0],
            "one_member_tuned_us": {f"{t['block'][0]}x{t['block'][1]}": t["us"]
                                    for t in tuned[(pname, gi, 0)][1]["timings"]},
        })
    for pname, wall_s in dispatch_s.items():
        kern_s = sum(tuned_check[key][1] * n for key, n in serve_launches.items() if key[0] == pname) / 1e3
        log(f"time serving {pname}: the load's kernels {kern_s:.4f} s of card time (tuned kernel ms x launches) "
            f"inside {wall_s:.4f} s of dispatch walls ({kern_s / wall_s:.3f}) -- {card}")
    # the user-facing entry points, end to end: argument checks, hdiff's seeding
    # copy of its input, vadv's scratch, and the launch
    def card_copy(t):
        return storage.card_tensor(t.shape, t.dtype, dev).copy_(t)

    entry = {}
    for layout, put in (("card", card_copy), ("c_order", lambda t: t)):
        xl, (al, bl, cl, dl) = put(x), (put(t) for t in (a, b, c, d))
        entry[layout] = (cuda_ms(lambda: hdiff_ops.hdiff(xl, 0.05), iters=20),
                         cuda_ms(lambda: vadv_ops.vadv(al, bl, cl, dl), iters=20))
    log(f"time entry points {DOMAIN} float64 (CUDA events, each call end to end; outputs in the card layout): "
        f"inputs in the card layout: ops.hdiff {entry['card'][0]:.4f} ms, ops.vadv {entry['card'][1]:.4f} ms; "
        f"inputs in C order: ops.hdiff {entry['c_order'][0]:.4f} ms, ops.vadv {entry['c_order'][1]:.4f} ms -- {card}")
    # flash attention at the LM's prefill shape (bfloat16, causal), arguments prepared once
    shape_q = (LM_BATCH, LM_PROMPT, lm_full.n_heads, lm_hd)
    shape_kv = (LM_BATCH, LM_PROMPT, lm_full.n_kv_heads, lm_hd)
    q, k, v = normal(shape_q, "bfloat16", 31), normal(shape_kv, "bfloat16", 32), normal(shape_kv, "bfloat16", 33)
    launch = flash_ops.prepare(q, k, v, causal=True)
    flash_ms = cuda_ms(launch, iters=20)
    flash_plain_ms = cuda_ms(lambda: flash_attention_ref(q, k, v, causal=True), iters=3)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))  # SDPA's (B, H, S, Dh)

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

    flash_lib_ms = cuda_ms(sdpa, iters=20)
    lib_diff = float((sdpa().transpose(1, 2).float() - launch().float()).abs().max())
    if not lib_diff <= FLASH_TOL["bfloat16"]:
        raise AssertionError(f"flash: scaled_dot_product_attention computes another function ({lib_diff:.3e})")
    pairs = LM_BATCH * lm_full.n_heads * LM_PROMPT * (LM_PROMPT + 1) // 2  # causal (q, k) pairs
    fl_flops = 4 * lm_hd * pairs
    fl_bytes = 2 * (2 * q.numel() + k.numel() + v.numel())  # q, k, v read once, o written once
    t_ops, t_bytes = fl_flops / PEAK_BF16_FLOPS, fl_bytes / HBM_BYTES_PER_S
    flash_bound = max(t_ops, t_bytes) * 1e3
    flash_by = "operations" if t_ops >= t_bytes else "bytes"
    log(f"time flash_attention {shape_q} bfloat16 causal: kernel {flash_ms:.4f} ms, plain torch "
        f"{flash_plain_ms:.4f} ms, library {flash_lib_ms:.4f} ms (scaled_dot_product_attention, max abs diff "
        f"from the kernel {lib_diff:.3e}), bound {flash_bound:.4f} ms ({flash_by}: {fl_flops / 1e9:.1f} GFLOP at "
        f"{PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s, {fl_bytes / 1e6:.1f} MB) -- {card}")
    log(f"lm_serve: flash kernel {lm_cfg.n_layers} x {flash_ms:.4f} ms = {lm_cfg.n_layers * flash_ms:.1f} ms, "
        f"{100 * lm_cfg.n_layers * flash_ms / (prefill_s * 1e3):.1f}% of the {prefill_s * 1e3:.1f} ms prefill")
    report.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_fwd_sm90.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:153", "launches": lm_launches,
        "max_abs_err": flash_err[(f"{LM_ARCH} prefill", "bfloat16")], "ms": flash_ms, "plain_ms": flash_plain_ms,
        "bound_ms": flash_bound, "bound_by": flash_by, "library_ms": flash_lib_ms,
    })
    # the float32 kernel (both products on the float64 tensor cores at Dh 96) at the same
    # shape, beside a float32 plain run and SDPA in float32; errors against a float64 plain run
    q, k, v, qt, kt, vt = (x_.float() for x_ in (q, k, v, qt, kt, vt))
    launch = flash_ops.prepare(q, k, v, causal=True)
    f32_ms = cuda_ms(launch, iters=10)
    f32_plain_ms = cuda_ms(lambda: flash_attention_ref(q, k, v, causal=True), iters=2, warmup=1)
    f32_lib_ms = cuda_ms(sdpa, iters=10)
    exact = flash_attention_ref(q.double(), k.double(), v.double(), causal=True)
    o32 = launch()
    f32_err = float((o32.double() - exact).abs().max())
    lib_err = float((sdpa().transpose(1, 2).double() - exact).abs().max())
    lib_diff = float((sdpa().transpose(1, 2) - o32).abs().max())
    del exact, o32
    if not lib_diff <= 1e-4:
        raise AssertionError(f"flash float32: scaled_dot_product_attention computes another function ({lib_diff:.3e})")
    if not f32_err <= FLASH_TOL["float32"]:
        raise AssertionError(f"flash float32 at {shape_q}: kernel {f32_err:.3e} from the float64 plain run")
    fl_bytes = 4 * (2 * q.numel() + k.numel() + v.numel())
    t_ops, t_bytes = fl_flops / PEAK_FLOPS["float32"], fl_bytes / HBM_BYTES_PER_S
    f32_bound = max(t_ops, t_bytes) * 1e3
    f32_by = "operations" if t_ops >= t_bytes else "bytes"
    log(f"time flash_attention {shape_q} float32 causal: kernel {f32_ms:.4f} ms, plain torch {f32_plain_ms:.4f} ms, "
        f"library {f32_lib_ms:.4f} ms (scaled_dot_product_attention, max abs diff from the kernel {lib_diff:.3e}), "
        f"bound {f32_bound:.4f} ms ({f32_by}: {fl_flops / 1e9:.1f} GFLOP at {PEAK_FLOPS['float32'] / 1e12:.0f} "
        f"TFLOP/s, the float32 rate of the CUDA cores and the float64 rate of the tensor cores, "
        f"{fl_bytes / 1e6:.1f} MB) -- {card}")
    log(f"time flash_attention {shape_q} float32 causal, against a float64 plain run: kernel {f32_ms:.4f} ms, "
        f"max_abs_err {f32_err:.3e}; scaled_dot_product_attention {f32_lib_ms:.4f} ms, max_abs_err "
        f"{lib_err:.3e} -- {card}")
    log(f"lm_serve float32: flash kernel {lm_cfg.n_layers} x {f32_ms:.4f} ms = {lm_cfg.n_layers * f32_ms:.1f} ms, "
        f"{100 * lm_cfg.n_layers * f32_ms / (prefill32_s * 1e3):.1f}% of the {prefill32_s * 1e3:.1f} ms prefill")
    report.append({
        "name": "flash_attention_float32", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_fwd.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:153", "launches": lm32_launches,
        "max_abs_err": flash_err[(f"{LM_ARCH} prefill", "float32")], "ms": f32_ms, "plain_ms": f32_plain_ms,
        "bound_ms": f32_bound, "bound_by": f32_by, "library_ms": f32_lib_ms,
        "library_max_abs_err": lib_err, "prefill_ms": prefill32_s * 1e3,
    })
    del q, k, v, qt, kt, vt, launch
    # the RG-LRU scan at RecurrentGemma-2B's width, float32, arguments prepared once
    launch = rglru_ops.prepare(a_rg, x_rg, h_rg)
    rglru_ms = cuda_ms(launch, iters=20)
    rglru_plain_ms = cuda_ms(lambda: rglru_scan_ref(a_rg, x_rg, h_rg), iters=2, warmup=1)
    rg_bytes = 4 * (3 * a_rg.numel() + h_rg.numel())  # a, b and h0 read once, y written once
    rg_flops = 2 * a_rg.numel()
    t_ops, t_bytes = rg_flops / PEAK_FLOPS["float32"], rg_bytes / HBM_BYTES_PER_S
    rglru_bound = max(t_ops, t_bytes) * 1e3
    rglru_by = "operations" if t_ops >= t_bytes else "bytes"
    log(f"time rglru_scan {RGLRU_SHAPE} float32: kernel {rglru_ms:.4f} ms, plain torch {rglru_plain_ms:.4f} ms, "
        f"no single PyTorch call, bound {rglru_bound:.4f} ms ({rglru_by}: {rg_bytes / 1e6:.1f} MB) -- {card}")
    a16, x16, h16 = rglru_inputs("bfloat16", 22)
    rglru_bf16_ms = cuda_ms(rglru_ops.prepare(a16, x16, h16), iters=20)
    rg16_bytes = 2 * 3 * a16.numel() + 4 * h16.numel()  # h0 is float32
    rglru_bf16_bound = max(rg_flops / PEAK_FLOPS["float32"], rg16_bytes / HBM_BYTES_PER_S) * 1e3
    log(f"time rglru_scan {RGLRU_SHAPE} bfloat16: kernel {rglru_bf16_ms:.4f} ms, bound {rglru_bf16_bound:.4f} ms "
        f"(bytes: {rg16_bytes / 1e6:.1f} MB) -- {card}")
    del a16, x16, h16
    report.append({
        "name": "rglru_scan", "route": "cuda", "source": "src/repro_torch/kernels/rglru/csrc/rglru_scan.cu",
        "replaces": "src/repro/kernels/rglru/kernel.py:62", "launches": rglru_launches,
        "max_abs_err": rglru_err["float32"], "ms": rglru_ms, "plain_ms": rglru_plain_ms,
        "bound_ms": rglru_bound, "bound_by": rglru_by, "library_ms": None,
        "ms_bfloat16": rglru_bf16_ms, "bound_ms_bfloat16": rglru_bf16_bound,
    })
    walls.mark("times")
    log(walls.line())
    log(f"card: {card}")
    print(json.dumps({"kernels": report}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
