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
   backend; (C) LM serving of phi3-mini-3.8b at full width, its depth cut
   to ``LM_LAYERS`` (8 of 32) to keep the script's wall in bounds with path
   H, with random weights: ``make_cache(4, 2080)``, ``prefill`` of a 4 x
   2048 prompt through the bfloat16 tensor-core flash kernel (one launch a
   layer, none of the float32 kernel), 32 greedy ``decode_step``s (no
   launch), held against the same run through the plain ``chunked``
   attention in bfloat16 and in float32 (the float32 prefill: one launch of
   the float32 kernel a layer); (D)
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
   device memory; (H) the other LM families at full width with random
   seeded weights, batch 4 and 32 greedy decode steps (``lm_families``, run
   after paths A-G have freed their memory): RecurrentGemma-2B (prompt
   4096, twice its window; bf16 and float32: 18 RG-LRU scans and 8 flash
   calls a prefill, none in decode), Moonlight-16B-A3B (bf16 weights drawn
   directly at full depth; float32 at 16 of its 48 layers; a flash call a
   layer; the plain rerun replays the path's expert choices), Mamba-2 370M
   (bf16, float32 and float64; no kernel; against its teacher-forced
   forward), Whisper-medium (1500 seeded frames encoded once: 24 flash
   calls, then 48 in prefill and 24 a decode step, the one-query cross
   attention) and InternVL2-1B (256 seeded patches ahead of the 2048-token
   prompt; 24 flash calls); each phase's launches asserted exactly, and the
   flash calls counted by shape; each model against a teacher-forced rerun
   through the plain versions, the runs ``H_MODELS`` marks held failing
   outside ``rtol=2e-2, atol=2e-3`` (float32, float64) or ``LM_BF16_REL``
   (bf16), every bf16 run printed beside the spread of its naive and
   chunked prefills, and a rerun holding every kernel call against its
   plain version on the model's own activations; prefill and decode walls,
   tokens/s, peak memory, and a ``torch.profiler`` breakdown of each
   model's first run (card time, launches, idle share); (I), run after
   paths A-G return and before path H: the distributed stencil path, four
   ranks spawned on the one card over gloo (``launch.ranks.run_ranks``), a
   (2, 2) ("data", "model") mesh over 512 x 512 x 80 float64, each rank the
   256 x 256 x 80 tile: the climate program distributed (10 calls, then
   ``iterate(10)``; two group launches a step, the plan's two exchanges a
   step), the eager chain of ``DistributedStencil``s (bit for bit the same),
   ``DistributedStencil(hdiff)``, and a 4-member ``DistributedEnsemble`` on
   a (2, 1, 2) ("ens", "data", "model") mesh over 256 x 512 x 80 (one launch
   a group and step, one exchange a buffer and step, for both members); each
   rank held within 1e-12 of single-domain runs on the card (the program
   over the zero-padded 518 x 518 x 80 domain, ``ops.hdiff``, each member
   alone); the step, its exchanges and its group kernels by CUDA events (max
   over ranks) beside the single-domain step; a failed or hung rank fails
   the script. The distributed groups build in phase 2; (J), run after path
   H: training (``path_j``): ``RGLRUScan``'s gradient at (1, 4096, 2560)
   against autograd through a float64 loop (and a == 0 exactly);
   RecurrentGemma-2B at full width and depth trained for 6 steps of 4
   microbatches of 1 x 4096 (float32 master weights and AdamW moments, bf16
   compute, chunked attention, remat), 208 RG-LRU launches a step asserted
   (forward, remat recompute and backward), the loss and grad norm finite
   and the loss falling, every moment finite and every RG-LRU leaf's
   non-zero, the step wall, tokens/s, share of bf16 peak, peak memory and a
   ``torch.profiler`` breakdown of the last step; one microbatch's loss and
   every leaf's gradient through the kernel against the plain scan; a
   bit-exact restart of two reduced configs under deterministic algorithms
   (a child process: ``chip_smoke.py --path-j-restart DIR``); one train step
   of every reduced config; ``int8_compress`` on the card against the CPU;
   the scan's forward and whole backward timed beside their bounds; (K), run
   after path J: the sharded half (``path_k``), four ranks spawned on the one
   card over gloo with DTensor's collectives staged through host buffers
   (``launch.ranks.run_ranks(..., backend="gloo_staged")``): K1 serves
   Moonlight-16B-A3B at full width (bf16 weights drawn from a seed, 12 of 48
   layers) expert-parallel on a (1, 4) mesh, 16 experts a rank, a 4 x 2048
   prefill through the bf16 flash kernel on each rank's 512 query rows (12
   launches a rank, asserted; every call held against ``ref.py``) and 4
   greedy decode steps on the row-sharded cache, held at ``LM_BF16_REL``
   against the single-rank run on the same weights with its expert choices
   replayed; K2 trains RecurrentGemma-2B at full width (3 of 26 layers) on a
   (2, 2) mesh, 3 steps of 4 x 4096 (float32 master weights, bf16 compute,
   chunked attention, remat; 36 RG-LRU launches a rank, asserted, the first
   two scans held to the plain loop's bits), its losses, gradient norms and
   every moment leaf held against the single-rank steps (a control run that
   leaves data rank 1's rows out must fail the moment gate), the step wall
   (max over ranks) and peak memory a rank printed; K3 restores K2's checkpoint
   on (1, 4) and on one rank, bit for bit; K4 lowers recurrentgemma-2b
   train_4k on a fake 16 x 16 process group with fake CUDA tensors and
   prints its GiB a rank, flops and collective bytes;
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
   kernel; after path H, each flash and RG-LRU shape it ran, beside its plain
   version, ``scaled_dot_product_attention`` (KV heads expanded, the window
   as an explicit boolean mask) and its bound; after path I, its group
   kernels (one-member and member-batched) and hdiff at a rank's tile;
   after path K, the flash and RG-LRU kernels at a rank's shapes there.

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
LM_LAYERS = 8  # path C's depth (of 32): cut when path H came, widths kept
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
# path I: four ranks on the one card over gloo, a (2, 2) ("data", "model")
# mesh over a 512 x 512 x 80 domain, each rank the 256 x 256 x 80 tile; the
# ensemble: 4 members on a (2, 1, 2) ("ens", "data", "model") mesh over
# 256 x 512 x 80, 2 members a rank
DIST_MESH, DIST_GLOBAL, DIST_LOCAL = (2, 2), (512, 512, 80), (256, 256, 80)
DIST_ENS_MESH, DIST_ENS_GLOBAL, DIST_MEMBERS = (2, 1, 2), (256, 512, 80), 4
DIST_TIMEOUT = 120  # seconds for the ranks' whole run, and the process group's timeout
HDIFF_ALPHA = 0.05
# path H: (arch, prompt, runs), each at full width, batch LM_BATCH; a run is
# (dtype, depth or None for the full one, whether its logits are held against
# the plain rerun).  bf16 runs are held where the bf16 rounding of the random
# model leaves the logits of two plain attentions well inside LM_BF16_REL (the
# spread printed beside each bf16 run); each model has at least one held run.
H_MODELS = (
    ("recurrentgemma-2b", 4096, (("bfloat16", None, False), ("float32", None, True))),  # twice the 2048 window
    # bf16 weights drawn directly at full depth; float32 at 16 of 48 layers,
    # as its full depth does not fit one card
    ("moonshot-v1-16b-a3b", 2048, (("bfloat16", None, False), ("float32", 16, True))),
    # float32 rounding alone moves Mamba-2's logits at full depth by more than
    # atol 2e-3 (the float64 run prints how far): its decode path is held in
    # float64 (the SSD too: ``ssm.ssd_block``), teacher-forced on the float32
    # run's tokens
    ("mamba2-370m", 2048, (("bfloat16", None, False), ("float32", None, False), ("float64", None, True))),
    ("whisper-medium", 64, (("bfloat16", None, True),)),  # and 1500 seeded frames
    ("internvl2-1b", 2048, (("bfloat16", None, True),)),  # and 256 seeded patch embeddings
)
H_STEPS = 32  # greedy decode steps
H_SLACK = 8  # cache rows past the last token
# path J: RecurrentGemma-2B trained at full width and depth (2,658,736,640
# parameters, float32 master weights, bf16 compute, chunked attention, remat),
# SyntheticLMDataset(vocab 256000, seq 4096, seed 0), 6 steps of global batch
# 4 (train_4k's 256, cut) as 4 microbatches of 1 x 4096, lr 3e-4, warmup 2
J_ARCH, J_PARAMS = "recurrentgemma-2b", 2_658_736_640
J_STEPS, J_BATCH, J_MICRO, J_SEQ, J_LR, J_WARMUP = 6, 4, 4, 4096, 3e-4, 2
J_SCAN = (1, 4096, 2560)  # one microbatch's RG-LRU scan
J_SCAN_REL = 1e-5  # (da, db, dh0) against autograd through a float64 loop, of the largest
J_MODEL_REL = 1e-5  # a leaf's gradient through the kernel against the plain scan's, of its largest
J_RGLRU_LEAVES = ("w_x", "conv_w", "w_input_gate", "b_input_gate", "w_rec_gate", "b_rec_gate", "lambda_param")
# path K: the sharded half, four ranks on the one card (gloo through pinned
# host buffers: ``parallel/staged.py``).  K1: Moonlight-16B-A3B at full width,
# bf16 weights drawn directly, depth cut to K1_LAYERS, mesh (1, 4): 16 of the
# 64 experts a rank, prefill of 4 x 2048 (512 query rows a rank through the
# bf16 flash kernel), K1_STEPS greedy decode steps on the sharded cache.  K2:
# RecurrentGemma-2B at full width, depth cut to K2_LAYERS (one (rglru, rglru,
# attn) group), mesh (2, 2): K2_STEPS steps of global batch 4 x 4096 (2 rows
# a data rank, K2_MICRO microbatches), float32 master weights, bf16 compute,
# chunked attention, remat.
K_SEED, K_TIMEOUT = 7, 900
K1_ARCH, K1_LAYERS, K1_MESH, K1_BATCH, K1_PROMPT, K1_STEPS = "moonshot-v1-16b-a3b", 12, (1, 4), 4, 2048, 4
K2_ARCH, K2_LAYERS, K2_MESH, K2_BATCH, K2_SEQ, K2_MICRO, K2_STEPS = "recurrentgemma-2b", 3, (2, 2), 4, 4096, 2, 3
K2_LR, K2_WARMUP = 3e-4, 1
K2_SCAN_CHECKS = 2  # RG-LRU calls a rank holds to the plain loop's bits (the first forward scans)
# K2 held against the single-rank steps: the losses and gradient norms (a
# relative gate: bf16 compute in another order; on the CPU at reduced widths
# the sharded bf16 losses strayed 6.0e-4 and the gradient norms 1.1e-3), and
# every moment leaf (m and v: sums of the clipped gradients and of their
# squares, which AdamW's normalised update has not magnified) by
# ||sharded - single|| / ||single|| within K2_MOMENT_REL.  On the CPU at
# reduced width in K2's precision (tests/test_torch_sharded.py) a sound run
# reads 0.034, and one that drops data rank 1's gradient 1.20; here a control
# run, which leaves data rank 1's rows out of the loss, must exceed the gate.
K2_LOSS_REL, K2_MOMENT_REL = 5e-3, 0.2


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


def stencil_bound(st, domain, members=1, shared=()):
    """(bytes, flops) this call needs: each input region read once, each
    output written once; arithmetic nodes over each stage's region; a
    member-batched call reads and writes each member's fields, the
    ``shared`` ones once."""
    import numpy as np

    from repro_torch.core import ir

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


def lm_families(dev, card: str, configs) -> list:
    """Path H: the non-dense LM families served on the card, each at full
    width with random seeded weights, batch ``LM_BATCH``, ``H_STEPS`` greedy
    decode steps: ``make_cache`` → (enc-dec: ``encode``) → ``prefill`` →
    ``decode_step``, each phase's launches read exactly, then a teacher-forced
    rerun through the plain versions; then every new kernel shape the path ran,
    timed beside its plain version, SDPA and its bound.  ``configs`` maps each
    arch of ``H_MODELS`` to its config.  Returns the kernels' report rows."""
    import gc
    from collections import Counter

    import torch

    from repro_torch.core import codegen_cuda
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.rglru import ops as rglru_ops
    from repro_torch.kernels.rglru.ref import rglru_scan_ref
    from repro_torch.models import build_model
    from repro_torch.models import moe as moe_mod

    flash_key = {"bfloat16": flash_ops.KERNEL_BF16.key, "float32": flash_ops.KERNEL.key}
    kernel_top_k = moe_mod._top_k
    gen = torch.Generator(device=dev)

    def sync():
        torch.cuda.synchronize()

    def counts():
        return {k: n for k, n in codegen_cuda.launch_counts().items() if n}

    def serve(model, params, batch, max_len, steps, forced=None, step_extra=None, tally=None, routes=None):
        """make_cache → (encode) → prefill → ``steps`` decode steps, greedy unless
        ``forced`` holds the tokens; host clock, synchronized.  Returns the
        logits (prefill first), the tokens, seconds and launches per phase.
        ``tally``, a Counter, counts the flash calls by (q shape, k shape,
        causal, window); ``routes`` (a ``Routes``) stands in for the MoE
        layers' top-k."""
        kernel_attention, top_k = flash_ops.flash_attention, moe_mod._top_k

        def tallied(q, k, v, **kw):
            tally[(tuple(q.shape), tuple(k.shape), kw["causal"], kw.get("window"))] += 1
            return kernel_attention(q, k, v, **kw)

        if tally is not None:
            flash_ops.flash_attention = tallied  # the models import it at each call
        if routes is not None:
            moe_mod._top_k = routes  # looked up at each call, likewise
        try:
            return _serve(model, params, batch, max_len, steps, forced, step_extra)
        finally:
            flash_ops.flash_attention, moe_mod._top_k = kernel_attention, top_k

    class Routes:
        """The MoE layers' top-k, recording each call's expert ids; or, given
        a recorded run, replaying its ids call for call (the gates from this
        run's own probabilities) and counting the tokens whose own top-k
        would have chosen other experts.  A plain rerun so takes the same
        discrete routes as the path: a rounding that flips one of a token's
        top-k experts moves the logits by far more than any tolerance."""

        def __init__(self, recorded=None):
            self.recorded, self.ids, self.flips, self.tokens = recorded, [], 0, 0

        def __call__(self, probs, k):
            vals, idx = kernel_top_k(probs, k)
            if self.recorded is not None:
                forced = self.recorded[len(self.ids)]
                self.flips += int((idx.sort(-1).values != forced.sort(-1).values).any(-1).sum())
                self.tokens += idx.numel() // k
                vals, idx = torch.gather(probs, -1, forced), forced
            self.ids.append(idx)
            return vals, idx

    def _serve(model, params, batch, max_len, steps, forced, step_extra):
        cache = model.make_cache(LM_BATCH, max_len, device=dev)
        secs, launched = {}, {}
        sync()
        codegen_cuda.reset_launch_counts()
        batch = dict(batch)
        if "frames" in batch:  # enc-dec: encode once, the cross K/V reused by every step
            t0 = time.perf_counter()
            enc_kv = model.encode(params, batch.pop("frames"))
            sync()
            secs["encode"], launched["encode"] = time.perf_counter() - t0, counts()
            codegen_cuda.reset_launch_counts()
            batch["enc_kv"] = step_extra["enc_kv"] = enc_kv
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, batch, cache)
        sync()
        secs["prefill"], launched["prefill"] = time.perf_counter() - t0, counts()
        codegen_cuda.reset_launch_counts()
        outs, toks = [logits], []
        t0 = time.perf_counter()
        for i in range(steps):
            tok = logits.argmax(dim=-1, keepdim=True) if forced is None else forced[i]
            toks.append(tok)
            logits, cache = model.decode_step(params, {"tokens": tok, **(step_extra or {})}, cache)
            outs.append(logits)
        sync()
        secs["decode"], launched["decode"] = time.perf_counter() - t0, counts()
        if int(cache["pos"]) != max_len - H_SLACK:
            raise AssertionError(f"{model.cfg.name}: cache position {int(cache['pos'])}, expected {max_len - H_SLACK}")
        return outs, toks, secs, launched

    def breakdown(model, params, batch, max_len):
        """One profiled (encode,) prefill and decode step: the card's time in
        kernels, the kernel launches and the three costliest kernels of each
        phase (torch.profiler, which stretches the host clock: the walls come
        from the unprofiled run).  ``card_ms`` is None when the profiler sees
        no device activity."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        def phase(fn):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                out = fn()
                sync()
            kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
            self_us = [getattr(e, "self_device_time_total", 0) for e in kernels]
            top = sorted(zip(self_us, kernels), key=lambda t: -t[0])[:3]
            return out, {"card_ms": sum(self_us) / 1e3 if kernels else None,
                         "kernels": sum(e.count for e in kernels),
                         "top": [[e.key[:48], us / 1e3] for us, e in top]}

        cache = model.make_cache(LM_BATCH, max_len, device=dev)
        batch, res = dict(batch), {}
        if "frames" in batch:
            frames = batch.pop("frames")
            batch["enc_kv"], res["encode"] = phase(lambda: model.encode(params, frames))
        (logits, cache), res["prefill"] = phase(lambda: model.prefill(params, batch, cache))
        step = {"tokens": logits.argmax(dim=-1, keepdim=True)}
        if "enc_kv" in batch:
            step["enc_kv"] = batch["enc_kv"]
        _, res["decode"] = phase(lambda: model.decode_step(params, step, cache))
        return res

    def layer_kinds(cfg):
        if cfg.family == "hybrid":
            pat = cfg.rglru.pattern
            return list(pat) * (cfg.n_layers // len(pat)) + [pat[r] for r in range(cfg.n_layers % len(pat))]
        return ["ssm" if cfg.family == "ssm" else "attn"] * cfg.n_layers

    def expected(cfg, dtype):
        """The launches each phase must make, and nothing else."""
        kinds = layer_kinds(cfg)
        fk = flash_key.get(dtype)  # none for float64 (the attention-free Mamba-2 alone)
        if cfg.is_encdec:  # encoder; decoder self + cross; the cross attention of every step
            return {"encode": {fk: cfg.n_encoder_layers}, "prefill": {fk: 2 * cfg.n_layers},
                    "decode": {fk: cfg.n_layers * H_STEPS}}
        pre = {fk: kinds.count("attn"), rglru_ops.KERNEL.key: kinds.count("rglru")}
        return {"prefill": {k: n for k, n in pre.items() if n}, "decode": {}}

    def rel_diff(a, b, vocab):
        a, b = a[:, :vocab], b[:, :vocab]
        if a.shape != b.shape or not torch.isfinite(a).all():
            raise AssertionError(f"logits of shape {tuple(a.shape)} against {tuple(b.shape)}, or non-finite")
        return float((a - b).abs().max()) / float(b.abs().max())

    def max_abs(outs, ref_outs, vocab):
        return max(float((a[:, :vocab].double() - b[:, :vocab].double()).abs().max()) for a, b in zip(outs, ref_outs))

    def compare(name, dtype, outs, ref_outs, vocab, held):
        """The largest difference over the steps: relative to the largest logit
        in bf16, absolute in float32 and float64; when ``held``, each step held
        to LM_BF16_REL in bf16, to rtol 2e-2, atol 2e-3 otherwise.  Returns it
        and the largest share of its limit (|diff| / (atol + rtol |plain|)
        outside bf16)."""
        worst = share = 0.0
        for i, (a, b) in enumerate(zip(outs, ref_outs)):
            if dtype == "bfloat16":
                rel = rel_diff(a, b, vocab)
                worst, share = max(worst, rel), max(share, rel / LM_BF16_REL)
                if held and not rel <= LM_BF16_REL:
                    raise AssertionError(f"{name} bfloat16 step {i}: max |diff| {rel:.3e} of max |logit|")
            else:
                a, b = a[:, :vocab], b[:, :vocab]
                if not torch.isfinite(a).all():
                    raise AssertionError(f"{name} {dtype} step {i}: non-finite logits")
                worst = max(worst, float((a - b).abs().max()))
                share = max(share, float(((a - b).abs() / (2e-3 + 2e-2 * b.abs())).max()))
                if held and not torch.allclose(a, b, rtol=2e-2, atol=2e-3):
                    raise AssertionError(f"{name} {dtype} step {i}: differs from the plain run by {worst:.3e}")
        return worst, share

    def shadowed(cfg, params, batch, max_len, toks):
        """A teacher-forced rerun in which every flash call is also computed by
        its plain version on the same inputs, the model's own activations, and
        held there at FLASH_TOL (against a float64 plain run for float32
        inputs); the plain rerun holds the RG-LRU scan likewise.  These
        launches are comparisons, not the path's.  Returns {kernel: (calls,
        max abs err)}."""
        seen = {}
        kernel_attention = flash_ops.flash_attention

        def note(key, err):
            calls, worst = seen.get(key, (0, 0.0))
            seen[key] = (calls + 1, max(worst, err))

        def attention(q, k, v, **kw):
            o = kernel_attention(q, k, v, **kw)
            work = (lambda x: x.double()) if q.dtype == torch.float32 else (lambda x: x)
            ref = flash_attention_ref(work(q), work(k), work(v), **kw).double()
            tol = FLASH_TOL["float32" if q.dtype == torch.float32 else "bfloat16"]
            err = float((o.double() - ref).abs().max())
            if not (torch.isfinite(o).all() and torch.allclose(o.double(), ref, rtol=tol, atol=tol)):
                raise AssertionError(f"{cfg.name} {cfg.dtype}: flash at q {tuple(q.shape)} kv {tuple(k.shape)} {kw} "
                                     f"differs from its plain version on the model's activations by {err:.3e}")
            note(flash_key[cfg.dtype], err)
            return o

        # decode steps only where decode launches a kernel (the enc-dec cross attention)
        steps = H_STEPS if cfg.is_encdec else 0
        flash_ops.flash_attention = attention  # the models import it at each call
        try:
            serve(build_model(cfg), params, batch, max_len - H_STEPS + steps, steps, forced=toks, step_extra={})
        finally:
            flash_ops.flash_attention = kernel_attention
        return seen

    shapes = {}  # (arch, label, dtype) -> (q or scan shape, kv shape or None, options, launches on the path)
    for arch, prompt_len, runs in H_MODELS:
        cfg0 = dataclasses.replace(configs[arch], attention_impl="flash")
        extra = cfg0.encoder_seq if cfg0.frontend == "vision" else 0
        max_len = extra + prompt_len + H_STEPS + H_SLACK
        gen.manual_seed(5)
        batch = {"tokens": torch.randint(0, cfg0.vocab, (LM_BATCH, prompt_len), generator=gen, device=dev)}
        if cfg0.frontend == "vision":
            batch["patches"] = torch.randn((LM_BATCH, cfg0.encoder_seq, cfg0.d_model), generator=gen, device=dev)
        if cfg0.is_encdec:
            batch["frames"] = torch.randn((LM_BATCH, cfg0.encoder_seq, cfg0.d_model), generator=gen, device=dev)
        master, master_key = None, None
        float32_run = float32_toks = None  # the float32 run's (logits, plain logits) and tokens
        for run, (dtype, depth, held) in enumerate(runs):
            cfg = dataclasses.replace(cfg0, dtype=dtype, n_layers=depth or cfg0.n_layers)
            if arch == "moonshot-v1-16b-a3b" and dtype == "bfloat16":
                # bf16 weights drawn directly: no float32 master beside them
                cfg = dataclasses.replace(cfg, param_dtype="bfloat16")
            if (cfg.n_layers, cfg.param_dtype) != master_key:
                master = None
                gc.collect()
                torch.cuda.empty_cache()
                free_b, total_b = torch.cuda.mem_get_info()
                log(f"path lm_families: {arch} {dtype}: {torch.cuda.memory_allocated() / 1e9:.2f} GB held before it, "
                    f"{free_b / 1e9:.1f} of {total_b / 1e9:.1f} GB free")
                master = build_model(cfg).init_params(gen.manual_seed(0), device=dev)
                master_key = (cfg.n_layers, cfg.param_dtype)
            torch.cuda.reset_peak_memory_stats()
            model = build_model(cfg)
            params = model.serving_params(master) if cfg.param_dtype != dtype else master
            step_extra, tally, routes = {}, Counter(), (Routes() if cfg.moe else None)
            serve(model, params, batch, max_len - H_STEPS + 2, 2, step_extra=step_extra)  # warm-up
            forced = float32_toks if dtype == "float64" else None
            outs, toks, secs, launched = serve(model, params, batch, max_len, H_STEPS, forced=forced,
                                               step_extra=step_extra, tally=tally, routes=routes)
            if dtype == "float32":
                float32_toks = toks
            want = expected(cfg, dtype)
            if launched != want:
                raise AssertionError(f"{arch} {dtype}: launches {launched}, expected exactly {want}")
            if sum(tally.values()) != sum(n.get(flash_key.get(dtype), 0) for n in launched.values()):
                raise AssertionError(f"{arch} {dtype}: flash calls by shape {dict(tally)}, launches {launched}")
            spread = None
            if cfg.family == "ssm":
                # no kernel on this path: against the teacher-forced
                # full-sequence forward, itself a plain version
                seq = torch.cat([batch["tokens"]] + toks, dim=1)
                full, _ = model.forward(params, {"tokens": seq})
                ref_outs = [full[:, prompt_len - 1 + i] for i in range(H_STEPS + 1)]
                plain_what, shadow = "the teacher-forced forward over the whole sequence", {}
                del full
                if dtype == "float64":  # the float32 run's rounding, on its own tokens
                    f32_outs, f32_ref = float32_run
                    plain_what += (f" (the float32 run's decode and forward lie {max_abs(f32_outs, ref_outs, cfg.vocab):.3e}"
                                   f" and {max_abs(f32_ref, ref_outs, cfg.vocab):.3e} from this forward)")
                elif dtype == "float32":
                    float32_run = (outs, ref_outs)
            else:
                scans = []

                def plain_scan(a, b, h0=None):
                    """The plain loop, and the kernel held to its bits on the same inputs."""
                    y = rglru_scan_ref(a, b, h0)
                    if not torch.equal(rglru_ops.rglru_scan(a, b, h0), y):
                        raise AssertionError(f"{arch}: rglru_scan at {tuple(a.shape)} is not the plain loop's "
                                             f"bits on the model's activations")
                    scans.append(tuple(a.shape))
                    return y

                plain = build_model(dataclasses.replace(cfg, attention_impl="chunked"), plain_scan)
                plain_routes = Routes(routes.ids) if cfg.moe else None
                ref_outs, _, plain_secs, plain_launched = serve(plain, params, batch, max_len, H_STEPS, forced=toks,
                                                                step_extra={}, routes=plain_routes)
                if {k: n for k, n in plain_launched["prefill"].items() if k != rglru_ops.KERNEL.key} or any(
                        plain_launched["decode"].values()) or len(scans) != plain_launched["prefill"].get(
                            rglru_ops.KERNEL.key, 0):
                    raise AssertionError(f"{arch} {dtype}: the plain rerun launched {plain_launched}")
                plain_what = (f"a teacher-forced rerun through chunked attention{', rglru_scan_ref' if cfg.rglru else ''}"
                              f" (prefill {plain_secs['prefill'] * 1e3:.1f} ms)")
                if cfg.moe:
                    if len(plain_routes.ids) != len(routes.ids):
                        raise AssertionError(f"{arch} {dtype}: {len(routes.ids)} MoE calls on the path, "
                                             f"{len(plain_routes.ids)} in the plain rerun")
                    plain_what += (f", the path's expert choices replayed (its own top-k would have routed "
                                   f"{plain_routes.flips} of {plain_routes.tokens} token-layers otherwise)")
                if dtype == "bfloat16":
                    # printed beside the result: the spread of two plain attentions in
                    # this dtype, the naive prefill against the chunked one (the scan
                    # through the kernel, which gives the plain loop's bits)
                    naive = build_model(dataclasses.replace(cfg, attention_impl="naive"))
                    spread = rel_diff(serve(naive, params, batch, extra + prompt_len + H_SLACK, 0,
                                            step_extra={})[0][0], ref_outs[0], cfg.vocab)
                shadow = shadowed(cfg, params, batch, max_len, toks)
                if scans:
                    shadow[rglru_ops.KERNEL.key] = (len(scans), 0.0)
                if {k: c for k, (c, _e) in shadow.items()} != dict(sum(map(Counter, launched.values()), Counter())):
                    raise AssertionError(f"{arch} {dtype}: the shadowed rerun compared {shadow}, the path launched "
                                         f"{launched}")
            worst, share = compare(arch, dtype, outs, ref_outs, cfg.vocab, held)
            if run == 0:
                walls_ms = {"encode": secs.get("encode", 0) * 1e3, "prefill": secs["prefill"] * 1e3,
                            "decode": secs["decode"] / H_STEPS * 1e3}
                for ph, b in breakdown(model, params, batch, max_len).items():
                    idle = "not measured" if b["card_ms"] is None else f"{1 - b['card_ms'] / walls_ms[ph]:.3f}"
                    card_ms = "not measured" if b["card_ms"] is None else f"{b['card_ms']:.2f} ms"
                    log(f"breakdown {arch} {dtype} {ph}: card time in kernels {card_ms} (torch.profiler) in a "
                        f"{walls_ms[ph]:.2f} ms wall{' a step' if ph == 'decode' else ''} (device idle share "
                        f"{idle}); {b['kernels']} kernel launches; costliest {b['top']} -- {card}")
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            wgb = sum(p.numel() * p.element_size() for p in params.parameters()) / 1e9
            enc = f"encode {secs['encode'] * 1e3:.1f} ms, " if "encode" in secs else ""
            log(f"path lm_families: {arch} ({cfg.family}, {cfg.n_layers} of {cfg0.n_layers} layers, d_model "
                f"{cfg.d_model}) {dtype}, attention_impl=flash, batch {LM_BATCH}, prompt {prompt_len}"
                f"{f' + {extra} patches' if extra else ''}, {H_STEPS} greedy decode steps; launches {launched}; "
                f"flash calls by (q, k, causal, window) {dict(tally)}")
            gate = f"{LM_BF16_REL:g} of the largest logit" if dtype == "bfloat16" else "rtol 2e-2, atol 2e-3"
            limit = f"{'held at' if held else 'not held; the gate'} {gate}, {share:.3f} of it at most"
            if spread is not None:
                limit += f"; the naive and chunked prefills {spread:.3e} apart"
            log(f"lm_families {arch} {dtype}{f' ({cfg.n_layers} layers)' if depth else ''}: {enc}prefill "
                f"{secs['prefill'] * 1e3:.1f} ms; decode {secs['decode'] / H_STEPS * 1e3:.2f} ms per step, "
                f"{LM_BATCH * H_STEPS / secs['decode']:.1f} tokens/s; weights {wgb:.2f} GB "
                f"{cfg.param_dtype if params is master else dtype}; peak device memory {peak_gb:.2f} GB; against "
                f"{plain_what}: max {'|diff| / max |logit|' if dtype == 'bfloat16' else 'abs diff'} {worst:.3e} "
                f"({limit}); every kernel call against its plain version on the same activations (calls, max abs "
                f"err): {shadow} (host clock, synchronized) -- {card}")
            del outs, ref_outs, params, model
            # the attention and scan shapes this run launched, for the times below
            if cfg.family == "ssm":
                continue
            hd, h, kh = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
            s_in = extra + prompt_len
            n = launched
            calls = {}  # label -> (q shape, kv shape, options)
            if cfg.is_encdec:
                se = cfg.encoder_seq
                calls["encoder"] = ((LM_BATCH, se, h, hd), (LM_BATCH, se, kh, hd), {"causal": False})
                calls["decoder"] = ((LM_BATCH, s_in, h, hd), (LM_BATCH, s_in, kh, hd), {"causal": True})
                calls["cross"] = ((LM_BATCH, s_in, h, hd), (LM_BATCH, se, kh, hd), {"causal": False})
                calls["cross_decode"] = ((LM_BATCH, 1, h, hd), (LM_BATCH, se, kh, hd), {"causal": False})
            else:
                opts = {"causal": True, **({"window": cfg.sliding_window} if cfg.sliding_window else {})}
                calls["prefill"] = ((LM_BATCH, s_in, h, hd), (LM_BATCH, s_in, kh, hd), opts)
            for label, (q_shape, kv_shape, opts) in calls.items():
                shapes[(arch, label, dtype)] = (q_shape, kv_shape, opts,
                                                tally[(q_shape, kv_shape, opts["causal"], opts.get("window"))])
            if sum(v[3] for k, v in shapes.items() if k[0] == arch and k[2] == dtype) != sum(tally.values()):
                raise AssertionError(f"{arch} {dtype}: flash calls by shape {dict(tally)}, rows {calls}")
            if cfg.rglru is not None:  # float32 whatever the model's dtype
                dr = cfg.rglru.d_rnn or int(1.5 * cfg.d_model)
                shapes[(arch, f"rglru.{dtype}", dtype)] = ((LM_BATCH, s_in, dr), None, {},
                                                           n["prefill"][rglru_ops.KERNEL.key])
        del master

    # ---- times: every new kernel shape of the path, beside its plain version, SDPA and its bound
    gc.collect()
    torch.cuda.empty_cache()
    rows = []

    def normal(shape, dtype, seed):
        gen.manual_seed(seed)
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(getattr(torch, dtype))

    for (arch, label, dtype), (q_shape, kv_shape, opts, n_launch) in shapes.items():
        if label.startswith("rglru"):
            gen.manual_seed(41)
            a = 0.5 + 0.499 * torch.rand(q_shape, generator=gen, device=dev)
            b, h0 = normal(q_shape, "float32", 42), normal((q_shape[0], q_shape[2]), "float32", 43)
            launch = rglru_ops.prepare(a, b, h0)
            ms = cuda_ms(launch, iters=20)
            err = float((launch().float() - rglru_scan_ref(a, b, h0)).abs().max())
            plain_ms = cuda_ms(lambda: rglru_scan_ref(a, b, h0), iters=1, warmup=1)
            nbytes, flops = 4 * (3 * a.numel() + h0.numel()), 2 * a.numel()
            t_ops, t_bytes = flops / PEAK_FLOPS["float32"], nbytes / HBM_BYTES_PER_S
            lib_ms, lib_text = None, "no single PyTorch call"
            name = f"rglru_scan.{arch}.{dtype}_model"
            if err > RGLRU_TOL["float32"]:
                raise AssertionError(f"{name}: the kernel differs from the plain loop by {err:.3e}")
            del a, b, h0
        else:
            q, k, v = normal(q_shape, dtype, 31), normal(kv_shape, dtype, 32), normal(kv_shape, dtype, 33)
            launch = flash_ops.prepare(q, k, v, **opts)
            ms = cuda_ms(launch, iters=10)
            work = (lambda x: x.double()) if dtype == "float32" else (lambda x: x)
            ref = flash_attention_ref(work(q), work(k), work(v), **opts)
            got = launch()
            err = float((got.double() - ref.double()).abs().max())
            tol = FLASH_TOL[dtype]
            if not (torch.isfinite(got).all() and torch.allclose(got.double(), ref.double(), rtol=tol, atol=tol)):
                raise AssertionError(f"flash {arch} {label} {dtype}: the kernel differs from the plain version by {err:.3e}")
            del ref, got
            plain_ms = cuda_ms(lambda: flash_attention_ref(q, k, v, **opts), iters=1, warmup=1)
            # SDPA in (B, H, S, Dh), the KV heads expanded, the window as an explicit boolean mask
            rep = q_shape[2] // kv_shape[2]
            qt, kt, vt = (x.transpose(1, 2).repeat_interleave(r, dim=1).contiguous() for x, r in ((q, 1), (k, rep), (v, rep)))
            sq, skv = q_shape[1], kv_shape[1]
            qpos, kpos = torch.arange(sq, device=dev)[:, None], torch.arange(skv, device=dev)[None, :]
            if "window" in opts:
                mask = (kpos <= qpos) & (kpos > qpos - opts["window"])
                sdpa_kw = {"attn_mask": mask}
            else:
                mask = (kpos <= qpos) if opts["causal"] else torch.ones((sq, skv), dtype=torch.bool, device=dev)
                sdpa_kw = {"is_causal": opts["causal"]}

            def sdpa():
                return torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, **sdpa_kw)

            lib_ms = cuda_ms(sdpa, iters=10)
            lib_diff = float((sdpa().transpose(1, 2).double() - launch().double()).abs().max())
            if not lib_diff <= (FLASH_TOL["bfloat16"] if dtype == "bfloat16" else 1e-4):
                raise AssertionError(f"flash {arch} {label}: SDPA computes another function ({lib_diff:.3e})")
            pairs = int(mask.sum()) * q_shape[0] * q_shape[2]  # (q, k) pairs this run's masks keep
            flops = 4 * q_shape[3] * pairs
            nbytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel())
            peak = PEAK_BF16_FLOPS if dtype == "bfloat16" else PEAK_FLOPS["float32"]
            t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_PER_S
            lib_text = f"SDPA {lib_ms:.4f} ms (max abs diff from the kernel {lib_diff:.3e})"
            name = f"flash_attention{'_float32' if dtype == 'float32' else ''}.{arch}.{label}"
            del q, k, v, qt, kt, vt, mask
        bound_ms, bound_by = max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")
        log(f"time {name} {q_shape}{'' if kv_shape is None else f' kv {kv_shape}'} {'float32' if kv_shape is None else dtype} "
            f"{opts}: kernel {ms:.4f} ms, plain torch {plain_ms:.4f} ms, {lib_text}, bound {bound_ms:.4f} ms "
            f"({bound_by}: {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB); max_abs_err {err:.3e}; launches on the "
            f"path {n_launch} -- {card}")
        rows.append({
            "name": name, "route": "cuda",
            "source": ("src/repro_torch/kernels/rglru/csrc/rglru_scan.cu" if kv_shape is None else
                       "src/repro_torch/kernels/flash_attention/csrc/"
                       + ("flash_fwd_sm90.cu" if dtype == "bfloat16" else "flash_fwd.cu")),
            "replaces": ("src/repro/kernels/rglru/kernel.py:62" if kv_shape is None else
                         "src/repro/kernels/flash_attention/kernel.py:153"),
            "launches": n_launch, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib_ms, "model": arch, "model_dtype": dtype,
        })
        del launch
    return rows


def path_j_restart(outdir: str) -> int:
    """Path J's restart phase, in a child process that the parent starts with
    ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` (it must be set before CUDA
    initialises): under ``torch.use_deterministic_algorithms(True)`` (cuBLAS
    and the embedding backward are not deterministic by default), phi3-mini's
    and RecurrentGemma's reduced configs train 8 steps straight on the card,
    and again with a crash at step 6 and a restart from the step-4
    checkpoint; prints whether each pair of final parameters is the same bits,
    and the first differing leaf.  ``tests/test_torch_train_gpu.py`` runs the
    same program."""
    import shutil

    import torch

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import SyntheticLMDataset
    from repro_torch.models import build_model
    from repro_torch.runtime.loop import Trainer, _InjectedFault, make_train_step

    torch.use_deterministic_algorithms(True)
    out = {}
    for arch in ("phi3-mini-3.8b", "recurrentgemma-2b"):
        states, seconds = [], []
        for crash in (False, True):
            cfg = get_arch(arch).reduced
            model = build_model(cfg)
            ds = SyntheticLMDataset(vocab=cfg.vocab, seq_len=32, global_batch=4, seed=0)
            ckpt = Path(outdir) / arch / ("crash" if crash else "straight")
            shutil.rmtree(ckpt, ignore_errors=True)
            trainer = Trainer(model, ds, str(ckpt), ckpt_every=4,
                              train_step=make_train_step(model, base_lr=1e-3, warmup_steps=2, total_steps=50))
            hit = {"done": not crash}

            def fault(step, hit=hit):
                if step == 6 and not hit["done"]:
                    hit["done"] = True
                    raise _InjectedFault("node died")

            t0 = time.perf_counter()
            states.append(trainer.run(8, fault_hook=fault))
            seconds.append(time.perf_counter() - t0)
            if not hit["done"] or int(states[-1].step) != 8:
                raise AssertionError(f"{arch}: the run ended at step {int(states[-1].step)}, fault hit {hit['done']}")
        differ = [p for (p, a), (_q, b) in zip(states[0].params.leaves(), states[1].params.leaves())
                  if not torch.equal(a, b)]
        out[arch] = {"bit_exact": not differ, "first_differing": differ[:1], "leaves": len(states[0].params.leaves()),
                     "device": str(states[1].params.leaves()[0][1].device), "seconds": seconds}
    print(json.dumps(out), flush=True)
    return 0


def path_j(dev, card: str) -> list:
    """Path J: training on the card.  (1) ``RGLRUScan``'s gradient at
    (1, 4096, 2560) against autograd through a float64 loop; (2)
    RecurrentGemma-2B at full width and depth, ``J_STEPS`` steps through
    ``init_train_state``/``make_train_step`` on ``SyntheticLMDataset``
    batches, every launch read, the loss and grad norm finite, every moment
    finite, the RG-LRU leaves' moments non-zero, the loss falling, a
    ``torch.profiler`` breakdown of the last step; (3) one microbatch's loss
    and every leaf's gradient through the kernel against
    ``build_model(cfg, rglru_scan_ref)``; (4) the restart phase
    (``path_j_restart``, a child process); (5) one train step of each of the
    10 reduced configs; (6) ``int8_compress`` on the card against the CPU.
    Returns the kernels' report rows ``rglru_scan.train_fwd`` and
    ``rglru_scan.train_bwd``."""
    import gc
    import os
    import shutil
    from collections import Counter

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_arch, list_archs
    from repro_torch.core import codegen_cuda
    from repro_torch.data.pipeline import SyntheticLMDataset
    from repro_torch.kernels.rglru import ops as rglru_ops
    from repro_torch.kernels.rglru.ref import rglru_scan_ref
    from repro_torch.models import build_model, exact_param_count
    from repro_torch.models.layers import tree_leaves
    from repro_torch.runtime.compression import int8_compress
    from repro_torch.runtime.loop import init_train_state, make_train_step

    gen = torch.Generator(device=dev)
    t_phase = time.perf_counter()

    def phase_done(name):
        nonlocal t_phase
        now = time.perf_counter()
        log(f"path J {name}: {now - t_phase:.1f} s")
        t_phase = now

    # ---- J1: the scan's gradient on the card, against autograd through a float64 loop
    gen.manual_seed(51)
    a = 0.001 + 0.998 * torch.rand(J_SCAN, generator=gen, device=dev)
    b, dy = torch.randn(J_SCAN, generator=gen, device=dev), torch.randn(J_SCAN, generator=gen, device=dev)
    h0 = torch.randn((J_SCAN[0], J_SCAN[2]), generator=gen, device=dev)
    inputs = [t.clone().requires_grad_() for t in (a, b, h0)]
    y = rglru_ops.rglru_scan(*inputs)
    if y.grad_fn is None:
        raise AssertionError("rglru_scan under grad returned a tensor with no grad_fn")
    y.backward(dy)
    ref = [t.double().requires_grad_() for t in (a, b, h0)]
    h, ys = ref[2], []
    for t in range(J_SCAN[1]):
        h = ref[0][:, t] * h + ref[1][:, t]
        ys.append(h)
    torch.stack(ys, dim=1).backward(dy.double())
    del ys, h
    scan_err, scan_rel = {}, {}
    for name, got, want in zip(("da", "db", "dh0"), inputs, ref):
        scan_err[name] = float((got.grad.double() - want.grad).abs().max())
        scan_rel[name] = scan_err[name] / float(want.grad.abs().max())
    if not max(scan_rel.values()) <= J_SCAN_REL:
        raise AssertionError(f"RGLRUScan's gradient at {J_SCAN}: {scan_rel} of the largest float64 gradient "
                             f"(gate {J_SCAN_REL:g})")
    zero = [torch.zeros(J_SCAN, device=dev, requires_grad=True), b.clone().requires_grad_(),
            h0.clone().requires_grad_()]
    rglru_ops.rglru_scan(*zero).backward(dy)
    if not (torch.equal(zero[1].grad, dy) and torch.equal(zero[2].grad, torch.zeros_like(h0))):
        raise AssertionError("RGLRUScan with a == 0: db is not dy or dh0 is not 0")
    log(f"check RGLRUScan gradient at {J_SCAN} float32 with h0, against autograd through a float64 loop: max abs "
        f"err {scan_err} = {scan_rel} of the largest (gate {J_SCAN_REL:g}); a == 0 gives db == dy and dh0 == 0 "
        f"exactly")
    # its times: the forward launch, and the whole backward (flips, the reversed scan, da, db, dh0)
    fwd = rglru_ops.prepare(a, b, h0)
    fwd_ms = cuda_ms(fwd, iters=20)
    y = fwd()
    fwd_err = float((y - rglru_scan_ref(a, b, h0)).abs().max())
    bwd_ms = cuda_ms(lambda: rglru_ops.rglru_scan_backward(a, y, h0, dy), iters=20)
    rev = rglru_ops.prepare(a, torch.flip(dy, [1]).contiguous())  # the reversed scan alone
    rev_ms = cuda_ms(rev, iters=20)
    fwd_plain_ms = cuda_ms(lambda: rglru_scan_ref(a, b, h0), iters=1, warmup=1)
    # the plain backward: autograd through the plain loop's graph, built once outside the timing
    plain_in = [t.clone().requires_grad_() for t in (a, b, h0)]
    plain_y = rglru_scan_ref(*plain_in)
    bwd_plain_ms = cuda_ms(lambda: torch.autograd.grad(plain_y, plain_in, dy, retain_graph=True), iters=1, warmup=1)
    del plain_in, plain_y
    n = a.numel()
    # bytes: forward reads a, b (h0) and writes y; the backward at its least reads dy, a, y (h0) and
    # writes da, db (dh0); operations: 2 an element forward, 3 backward (g, then da)
    fwd_bytes, bwd_bytes = 4 * (3 * n + h0.numel()), 4 * (5 * n + 2 * h0.numel())
    bounds = {}
    for key, nbytes, flops in (("fwd", fwd_bytes, 2 * n), ("bwd", bwd_bytes, 3 * n)):
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS["float32"]
        bounds[key] = (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations", nbytes)
    log(f"time rglru_scan.train_fwd {J_SCAN} float32: kernel {fwd_ms:.4f} ms, plain torch {fwd_plain_ms:.4f} ms, "
        f"bound {bounds['fwd'][0]:.4f} ms ({bounds['fwd'][1]}: {bounds['fwd'][2] / 1e6:.1f} MB); max_abs_err "
        f"{fwd_err:.3e} against the plain loop -- {card}")
    log(f"time rglru_scan.train_bwd {J_SCAN} float32 (torch.flip copies, the reversed scan, da = g·h_prev, db, "
        f"dh0): {bwd_ms:.4f} ms, of which the reversed scan alone {rev_ms:.4f} ms; plain torch (autograd "
        f"through the plain loop) {bwd_plain_ms:.4f} ms; bound {bounds['bwd'][0]:.4f} ms "
        f"({bounds['bwd'][1]}: {bounds['bwd'][2] / 1e6:.1f} MB) -- {card}")
    del a, b, dy, h0, inputs, ref, zero, y, fwd, rev
    phase_done("J1 (the scan's gradient and its times)")

    # ---- J2: RecurrentGemma-2B, full width and depth, trained on the card
    cfg = get_arch(J_ARCH).full
    if (cfg.attention_impl, cfg.param_dtype, cfg.dtype) != ("chunked", "float32", "bfloat16"):
        raise AssertionError(f"{J_ARCH}: {cfg.attention_impl}, {cfg.param_dtype}, {cfg.dtype}")
    n_params = exact_param_count(cfg)
    if n_params != J_PARAMS:
        raise AssertionError(f"{J_ARCH}: {n_params} parameters, expected {J_PARAMS}")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg)
    t0 = time.perf_counter()
    state = init_train_state(model, torch.Generator().manual_seed(0), device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    state_gb = torch.cuda.memory_allocated() / 1e9
    ds = SyntheticLMDataset(vocab=cfg.vocab, seq_len=J_SEQ, global_batch=J_BATCH, seed=0)
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in ds.batch_at(s).items()} for s in range(J_STEPS + 1)]
    step_fn = make_train_step(model, base_lr=J_LR, warmup_steps=J_WARMUP, total_steps=J_STEPS, microbatches=J_MICRO)
    n_groups, n_tail = divmod(cfg.n_layers, len(cfg.rglru.pattern))
    grouped = n_groups * sum(k == "rglru" for k in cfg.rglru.pattern)
    tail = sum(cfg.rglru.pattern[r % len(cfg.rglru.pattern)] == "rglru" for r in range(n_tail))
    per_mb = 3 * grouped + 2 * tail  # forward, remat recompute and backward; the tail: forward and backward
    per_step = J_MICRO * per_mb
    # the kernel's launches by direction: a backward scan is one inside rglru_scan_backward
    kernel_scan, kernel_backward = rglru_ops._scan, rglru_ops.rglru_scan_backward
    tally, where = Counter(), ["fwd"]

    def tallied_scan(*args, **kw):
        tally[where[0]] += 1
        return kernel_scan(*args, **kw)

    def marked_backward(*args, **kw):
        where[0] = "bwd"
        try:
            return kernel_backward(*args, **kw)
        finally:
            where[0] = "fwd"

    def rglru_leaf(path):
        """Whether ``path`` is one of an RG-LRU layer's leaves that only the scan's gradient reaches."""
        parts = path.split("/")
        return "rec" in parts and parts[parts.index("rec") + 1] in J_RGLRU_LEAVES

    def profiled(fn):
        """fn() under torch.profiler: its result, and the card time, the
        launches and the costliest kernels of the same run beside its wall
        (from inside the profiler's span: its start and its trace's
        processing are left out, its cost per operation is not)."""
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        self_us = [getattr(e, "self_device_time_total", 0) for e in kernels]
        top = sorted(zip(self_us, kernels), key=lambda t: -t[0])[:5]
        return out, {"wall_ms": wall_ms, "card_ms": sum(self_us) / 1e3 if kernels else None, "kernels": sum(e.count for e in kernels),
                     "top": [[e.key[:60], round(us / 1e3, 2)] for us, e in top]}

    walls_s, losses, gnorms, step_launches, prof = [], [], [], [], None
    rglru_ops._scan, rglru_ops.rglru_scan_backward = tallied_scan, marked_backward
    try:
        torch.cuda.synchronize()
        codegen_cuda.reset_launch_counts()
        for s in range(J_STEPS):
            before = rglru_ops.KERNEL.launches
            t0 = time.perf_counter()
            if s == J_STEPS - 1:  # the last step under the profiler, out of the median wall
                (state, metrics), prof = profiled(lambda: step_fn(state, batches[s]))
            else:
                state, metrics = step_fn(state, batches[s])
            loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])  # synchronizes
            walls_s.append(time.perf_counter() - t0)
            step_launches.append(rglru_ops.KERNEL.launches - before)
            losses.append(loss)
            gnorms.append(gnorm)
            if not (np.isfinite(loss) and np.isfinite(gnorm)):
                raise AssertionError(f"{J_ARCH} step {s + 1}: loss {loss}, grad norm {gnorm}")
        torch.cuda.synchronize()
        launched = {k: n for k, n in codegen_cuda.launch_counts().items() if n}
    finally:
        rglru_ops._scan, rglru_ops.rglru_scan_backward = kernel_scan, kernel_backward
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if step_launches != [per_step] * J_STEPS or launched != {rglru_ops.KERNEL.key: per_step * J_STEPS}:
        raise AssertionError(f"{J_ARCH}: launches a step {step_launches}, in all {launched}; expected {per_step} "
                             f"a step ({J_MICRO} microbatches x (3 x {grouped} grouped + 2 x {tail} tail scans))")
    if dict(tally) != {"fwd": J_STEPS * J_MICRO * (2 * grouped + tail), "bwd": J_STEPS * J_MICRO * (grouped + tail)}:
        raise AssertionError(f"{J_ARCH}: scans by direction {dict(tally)}")
    if not np.mean(losses[-2:]) < losses[0]:
        raise AssertionError(f"{J_ARCH}: the loss did not fall: {losses}")
    bad, silent = [], []
    for (path, m), (_p, v) in zip(tree_leaves(state.opt.m), tree_leaves(state.opt.v)):
        if not (torch.isfinite(m).all() and torch.isfinite(v).all()):
            bad.append(path)
        if rglru_leaf(path) and not bool(m.any()):
            silent.append(path)
    rglru_moments = sum(rglru_leaf(p) for p, _m in tree_leaves(state.opt.m))
    if bad or silent or rglru_moments != len(J_RGLRU_LEAVES) * (grouped + tail):
        raise AssertionError(f"{J_ARCH}: moments not finite at {bad[:3]}, zero (no gradient through the scan) at "
                             f"{silent[:3]}; {rglru_moments} RG-LRU leaves")
    timed = walls_s[1:-1]  # step 1 warms cuBLAS and the allocator; the last ran under the profiler
    wall = float(np.median(timed))
    tokens = J_BATCH * J_SEQ
    tok_s = tokens / wall
    mfu = 6 * J_PARAMS * tok_s / PEAK_BF16_FLOPS
    log(f"path training: {J_ARCH} at full width and depth ({cfg.n_layers} layers, d_model {cfg.d_model}, vocab "
        f"{cfg.vocab}, {n_params:,} parameters, float32 master weights and AdamW moments, bf16 compute, "
        f"attention_impl={cfg.attention_impl}, remat on), {J_STEPS} steps of global batch {J_BATCH} x {J_SEQ} as "
        f"{J_MICRO} microbatches, lr {J_LR:g}, warmup {J_WARMUP}; init {init_s:.1f} s, state {state_gb:.2f} GB; "
        f"launches {launched} ({per_step} a step: {dict(tally)} forward and recompute / backward scans)")
    log(f"training: loss by step {[round(x, 4) for x in losses]}, grad norm {[round(x, 4) for x in gnorms]}; step walls "
        f"{[round(x, 3) for x in walls_s]} s (host clock, synchronized; the last under the profiler); median of steps "
        f"2-{J_STEPS - 1} {wall:.3f} s, {tok_s:.1f} tokens/s, {mfu:.4f} of bf16 peak ({PEAK_BF16_FLOPS / 1e12:.0f} "
        f"TFLOP/s) at 6 N FLOPs a token; peak device memory {peak_gb:.2f} GB "
        f"(torch.cuda.max_memory_allocated) -- {card}")
    # the idle share takes the card time and the wall of one step, the profiled step {J_STEPS}
    idle = "not measured" if prof["card_ms"] is None else f"{1 - prof['card_ms'] / prof['wall_ms']:.3f}"
    card_ms = "not measured" if prof["card_ms"] is None else f"{prof['card_ms']:.1f} ms"
    log(f"breakdown {J_ARCH} train step {J_STEPS}: card time in kernels {card_ms} (torch.profiler) in the same "
        f"step's {prof['wall_ms']:.1f} ms wall under the profiler (unprofiled median {wall * 1e3:.1f} ms) (device "
        f"idle share {idle}); {prof['kernels']} kernel launches; costliest {prof['top']} -- {card}")
    phase_done("J2 (training)")

    # ---- J3: one microbatch's gradients through the kernel against the plain scan's
    state = state._replace(opt=None)  # the moments are done with: room for two sets of gradients
    gc.collect()
    torch.cuda.empty_cache()
    params = state.params
    leaves = params.leaves()
    mb = {k: v[:1] for k, v in batches[J_STEPS].items()}

    def grads_of(m):
        for _p, x in leaves:
            x.grad = None
        codegen_cuda.reset_launch_counts()
        t0 = time.perf_counter()
        loss, _ = m.loss(params, mb)
        loss.backward()
        torch.cuda.synchronize()
        out = (float(loss.detach()), [x.grad for _p, x in leaves], rglru_ops.KERNEL.launches, time.perf_counter() - t0)
        for _p, x in leaves:
            x.grad = None
        return out

    loss_k, g_k, n_k, secs_k = grads_of(model)
    loss_p, g_p, n_p, secs_p = grads_of(build_model(cfg, rglru_scan_ref))
    if (n_k, n_p) != (per_mb, 0):
        raise AssertionError(f"{J_ARCH}: {n_k} launches through the kernel, {n_p} through the plain scan")
    worst, worst_at, bad, silent = 0.0, None, [], []
    for (path, _x), gk, gp in zip(leaves, g_k, g_p):
        if not torch.isfinite(gk).all():
            bad.append(path)
        if rglru_leaf(path) and not bool(gk.any()):
            silent.append(path)
        rel = float((gk - gp).abs().max()) / max(float(gp.abs().max()), 1e-30)
        if rel > worst:
            worst, worst_at = rel, path
    if bad or silent or not worst <= J_MODEL_REL:
        raise AssertionError(f"{J_ARCH}: gradients not finite at {bad[:3]}, zero at {silent[:3]}; the kernel's "
                             f"gradient {worst:.3e} of the plain one's largest at {worst_at} (gate {J_MODEL_REL:g})")
    log(f"training: one microbatch (1 x {J_SEQ}) of the trained model, loss {loss_k:.6f} through the kernel "
        f"({n_k} launches, {secs_k:.1f} s) and {loss_p:.6f} through the plain scan ({secs_p:.1f} s); every one of "
        f"{len(leaves)} leaves' gradients finite, the {len(J_RGLRU_LEAVES) * (grouped + tail)} RG-LRU leaves' "
        f"non-zero; largest per-leaf difference {worst:.3e} of that leaf's largest gradient, at {worst_at} (gate "
        f"{J_MODEL_REL:g}) -- {card}")
    del g_k, g_p, state, params, leaves, model, batches, mb
    gc.collect()
    torch.cuda.empty_cache()
    phase_done("J3 (kernel against plain on the model)")

    # ---- J4: restart, bit for bit, under deterministic algorithms (a child process)
    outdir = ROOT / ".gt_cache_torch" / "path_j"
    shutil.rmtree(outdir, ignore_errors=True)
    child = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), "--path-j-restart", str(outdir)],
                           capture_output=True, text=True, timeout=600,
                           env={**os.environ, "CUBLAS_WORKSPACE_CONFIG": ":4096:8"})
    if child.returncode != 0:
        raise AssertionError(f"path J restart child exited {child.returncode}:\n{child.stderr[-3000:]}")
    restart = json.loads(child.stdout.strip().splitlines()[-1])
    if sorted(restart) != ["phi3-mini-3.8b", "recurrentgemma-2b"] or not all(
            r["bit_exact"] and r["device"].startswith("cuda") for r in restart.values()):
        raise AssertionError(f"path J restart: {restart}")
    log(f"training restart (child process, torch.use_deterministic_algorithms(True), CUBLAS_WORKSPACE_CONFIG="
        f":4096:8): 8 steps straight against a crash at step 6 and a restart from the step-4 checkpoint, "
        f"reduced configs on the card: {restart}")
    shutil.rmtree(outdir, ignore_errors=True)
    phase_done("J4 (restart)")

    # ---- J5: one train step of every reduced config on the card
    fams = {}
    for arch in list_archs():
        rcfg = get_arch(arch).reduced
        rmodel = build_model(rcfg)
        rds = SyntheticLMDataset(vocab=rcfg.vocab, seq_len=16, global_batch=2, seed=0,
                                 frames_shape=(rcfg.encoder_seq, rcfg.d_model) if rcfg.is_encdec else None,
                                 patches_shape=(rcfg.encoder_seq, rcfg.d_model) if rcfg.frontend == "vision" else None)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in rds.batch_at(0).items()}
        rstate = init_train_state(rmodel, torch.Generator().manual_seed(1), device=dev)
        loss, _ = rmodel.loss(rstate.params, batch)
        loss.backward()
        loss = float(loss.detach())
        for path, x in rstate.params.leaves():
            if x.grad is None or x.grad.shape != x.shape or not torch.isfinite(x.grad).all():
                raise AssertionError(f"{arch}: the gradient of {path} is missing, misshapen or not finite")
        rstate, metrics = make_train_step(rmodel, warmup_steps=1)(rstate, batch)
        if not (np.isfinite(loss) and np.isfinite(float(metrics["loss"])) and int(rstate.step) == 1):
            raise AssertionError(f"{arch}: loss {loss}, train step {dict(metrics)}")
        fams[arch] = round(loss, 4)
    log(f"training every family: one train step of each reduced config on the card, every leaf's gradient finite "
        f"and shaped as its leaf; losses {fams}")

    # ---- J6: int8 compression on the card has the CPU's bits
    gen.manual_seed(61)
    x = torch.randn((4096, 2560), generator=gen, device=dev)
    x[0, :4] = torch.tensor([127.0, 0.5, 1.5, -2.5], device=dev) * (x.abs().max() / 127.0)
    q, scale = int8_compress(x)
    q_cpu, scale_cpu = int8_compress(x.cpu())
    if not (torch.equal(q.cpu(), q_cpu) and torch.equal(scale.cpu(), scale_cpu)):
        raise AssertionError("int8_compress on the card differs from the CPU")
    log(f"training compression: int8_compress of a (4096, 2560) float32 gradient on the card has the CPU's bits "
        f"(codes and scale {float(scale):.6e})")
    phase_done("J5-J6 (every family, compression)")

    rows = []
    for key, name, ms, plain_ms, launches, err in (
            ("fwd", "rglru_scan.train_fwd", fwd_ms, fwd_plain_ms, tally["fwd"], fwd_err),
            ("bwd", "rglru_scan.train_bwd", bwd_ms, bwd_plain_ms, tally["bwd"], max(scan_err.values()))):
        rows.append({"name": name, "route": "cuda", "source": "src/repro_torch/kernels/rglru/csrc/rglru_scan.cu",
                     "replaces": "src/repro/kernels/rglru/kernel.py:62", "launches": launches, "max_abs_err": err,
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": bounds[key][0], "bound_by": bounds[key][1],
                     "library_ms": None, "model": J_ARCH, "shape": list(J_SCAN)})
    return rows


# ---------------------------------------------------------------------------
# path K: the sharded half, four ranks on the one card
# ---------------------------------------------------------------------------


def _k_cfg(which: str):
    """Path K's configs at full width: K1 Moonlight (bf16 weights drawn
    directly, the flash kernel), K2 RecurrentGemma-2B (float32 master
    weights, bf16 compute, chunked attention); depth cut (``K*_LAYERS``)."""
    from repro_torch.configs import get_arch

    if which == "k1":
        return dataclasses.replace(get_arch(K1_ARCH).full, n_layers=K1_LAYERS, dtype="bfloat16",
                                   param_dtype="bfloat16", attention_impl="flash")
    return dataclasses.replace(get_arch(K2_ARCH).full, n_layers=K2_LAYERS)


def _k_prompt(vocab: int):
    import numpy as np
    import torch

    rng = np.random.default_rng(K_SEED)
    return torch.from_numpy(rng.integers(0, vocab, size=(K1_BATCH, K1_PROMPT), dtype=np.int32))


def _k2_batch(ds, step: int, dev):
    import torch

    return {k: torch.from_numpy(v).to(dev) for k, v in ds.batch_at(step).items()}


def _k2_rglru_launches(cfg) -> int:
    """RG-LRU launches of one rank's K2 run: each microbatch scans every
    rglru layer forward and backward, and again in the remat recompute of
    the (rglru, rglru, attn) groups (the tail layers are not recomputed)."""
    pat = cfg.rglru.pattern
    n_groups, rem = divmod(cfg.n_layers, len(pat))
    in_groups = n_groups * sum(k == "rglru" for k in pat)
    tails = sum(pat[r % len(pat)] == "rglru" for r in range(rem))
    return K2_STEPS * K2_MICRO * (2 * (in_groups + tails) + in_groups)


def _digests(tree) -> dict:
    """sha256 of every (whole, plain) leaf's bytes, by its path."""
    import hashlib

    import torch

    from repro_torch.models.layers import tree_leaves

    out = {}
    for path, t in tree_leaves(tree):
        host = t.detach().cpu()
        host = host.view(torch.int16) if host.dtype == torch.bfloat16 else host
        out[path] = hashlib.sha256(host.numpy().tobytes()).hexdigest()
    return out


def _moment_gap(got, ref) -> tuple:
    """(the largest over the moment leaves of two ``OptState``s of
    ||got - ref|| / ||ref||, that leaf's path)."""
    import torch

    from repro_torch.models.layers import tree_leaves

    worst = (0.0, "")
    for name in ("m", "v"):
        for (path, a), (_q, r) in zip(tree_leaves(getattr(got, name)), tree_leaves(getattr(ref, name))):
            den = float(torch.linalg.vector_norm(r.float()))
            diff = float(torch.linalg.vector_norm(a.float() - r.float()))
            worst = max(worst, (diff / den if den > 0 else diff, f"{name}/{path}"))
    return worst


def path_k_rank(rank: int, world: int, outdir: str) -> dict:
    """Path K on one of the four ranks that share the card (``gloo_staged``):
    K1 serves Moonlight expert-parallel on (1, 4) (prefill through the bf16
    flash kernel on the rank's 512 query rows, greedy decode steps on the
    sharded cache), recording its logits, tokens and expert choices for the
    parent's single-rank run; K2 trains RecurrentGemma-2B on (2, 2) and saves
    its state (K3 restores it on (1, 4) here and checks it bit for bit).
    Every flash call and the first RG-LRU scans are held against their plain
    versions on the rank's own activations."""
    import torch
    import torch.distributed as dist

    from repro_torch.checkpoint.store import load_checkpoint, save_checkpoint
    from repro_torch.core import codegen_cuda
    from repro_torch.data.pipeline import SyntheticLMDataset
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.rglru import ops as rglru_ops
    from repro_torch.kernels.rglru.ref import rglru_scan_ref
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.specs import (batch_shardings, cache_shardings, distribute_tree, init_sharded_params,
                                          init_sharded_state, param_shardings, serve_batch_shardings,
                                          state_shardings)
    from repro_torch.models import build_model
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.layers import tree_leaves
    from repro_torch.parallel.sharding import DEFAULT_RULES, axis_rules
    from repro_torch.runtime.loop import abstract_train_state, make_train_step

    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    outdir = Path(outdir)
    out = {"rank": rank}

    def sync_wall(t0):
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    # ---- K1: expert-parallel serving
    cfg = _k_cfg("k1")
    model = build_model(cfg)
    mesh = make_mesh(K1_MESH, ("data", "model"))
    flash_err, choices = [], []
    orig_flash, orig_top_k = flash_ops.flash_attention, moe_mod._top_k

    def checked_flash(q, k, v, **kw):
        o = orig_flash(q, k, v, **kw)
        ref = flash_attention_ref(q, k, v, **kw)
        tol = FLASH_TOL["bfloat16"]
        if not (torch.isfinite(o).all() and torch.allclose(o.float(), ref.float(), rtol=tol, atol=tol)):
            raise AssertionError(f"rank {rank}: flash on {tuple(q.shape)} off {kw.get('q_offset')} differs from "
                                 f"the plain version by {float((o.float() - ref.float()).abs().max()):.3e}")
        flash_err.append(float((o.float() - ref.float()).abs().max()))
        return o

    def recorded_top_k(probs, k):
        g, i = orig_top_k(probs, k)
        choices.append((i.full_tensor() if hasattr(i, "full_tensor") else i).to(torch.int16).cpu())
        return g, i

    flash_ops.flash_attention, moe_mod._top_k = checked_flash, recorded_top_k
    try:
        with axis_rules(DEFAULT_RULES, mesh):
            params = init_sharded_params(model, param_shardings(model, mesh), torch.Generator().manual_seed(K_SEED),
                                         dev)
            out["k1_param_bytes"] = sum(p.to_local().numel() * p.element_size() for _n, p in params.leaves())
            cache = model.make_cache(K1_BATCH, K1_PROMPT + K1_STEPS + H_SLACK, device=dev)
            cache = distribute_tree(cache, cache_shardings(mesh, cache))
            prompt = {"tokens": _k_prompt(cfg.vocab).to(dev)}
            torch.cuda.synchronize()
            dist.barrier()
            codegen_cuda.reset_launch_counts()
            t0 = time.perf_counter()
            with torch.no_grad():
                logits, cache = model.prefill(params, distribute_tree(prompt, serve_batch_shardings(mesh, prompt)),
                                              cache)
                out["k1_prefill_s"] = sync_wall(t0)
                out["k1_prefill_launches"] = dict(codegen_cuda.launch_counts())
                outs, toks = [logits.full_tensor().float().cpu()], []
                codegen_cuda.reset_launch_counts()
                t0 = time.perf_counter()
                for _ in range(K1_STEPS):
                    tok = outs[-1].argmax(-1, keepdim=True).to(torch.int32)
                    toks.append(tok)
                    b = {"tokens": tok.to(dev)}
                    logits, cache = model.decode_step(params, distribute_tree(b, serve_batch_shardings(mesh, b)),
                                                      cache)
                    outs.append(logits.full_tensor().float().cpu())
                out["k1_decode_s"] = sync_wall(t0) / K1_STEPS
                out["k1_decode_launches"] = dict(codegen_cuda.launch_counts())
        out["k1_flash_calls"], out["k1_flash_err"] = len(flash_err), max(flash_err, default=0.0)
        out["k1_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        if rank == 0:
            torch.save({"logits": outs, "tokens": toks, "choices": choices}, outdir / "k1.pt")
    finally:
        flash_ops.flash_attention, moe_mod._top_k = orig_flash, orig_top_k
    del params, cache, logits
    torch.cuda.empty_cache()

    # ---- K2: sharded training; K3: its checkpoint restored on (1, 4)
    scan_err = []

    def checked_scan(a, b, h0):
        y = rglru_ops.rglru_scan(a, b, h0)
        if len(scan_err) < K2_SCAN_CHECKS:  # the kernel gives the plain loop's bits
            with torch.no_grad():
                scan_err.append(float((y - rglru_scan_ref(a, b, h0)).abs().max()))
        return y

    cfg = _k_cfg("k2")
    model = build_model(cfg, rglru_scan=checked_scan)
    mesh = make_mesh(K2_MESH, ("data", "model"))
    ds = SyntheticLMDataset(vocab=cfg.vocab, seq_len=K2_SEQ, global_batch=K2_BATCH)
    with axis_rules(DEFAULT_RULES, mesh):
        state = init_sharded_state(model, state_shardings(model, mesh), torch.Generator().manual_seed(K_SEED), dev)
        step_fn = make_train_step(model, base_lr=K2_LR, warmup_steps=K2_WARMUP, total_steps=100,
                                  microbatches=K2_MICRO)
        torch.cuda.reset_peak_memory_stats()
        losses, gnorms, walls = [], [], []
        codegen_cuda.reset_launch_counts()
        for step in range(K2_STEPS):
            b = _k2_batch(ds, step, dev)
            b = distribute_tree(b, batch_shardings(mesh, b))
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            state, metrics = step_fn(state, b)
            walls.append(sync_wall(t0))
            losses.append(float(metrics["loss"]))
            gnorms.append(float(metrics["grad_norm"]))
        out["k2_launches"] = dict(codegen_cuda.launch_counts())
        out["k2_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        out.update(k2_losses=losses, k2_gnorms=gnorms, k2_walls=walls, k2_scan_err=scan_err)
        t0 = time.perf_counter()
        ckpt = outdir / "k2_ckpt"
        save_checkpoint(ckpt, K2_STEPS, state, keep=1)
        out["k3_save_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        mesh14 = make_mesh((1, 4), ("data", "model"))
        _s, restored = load_checkpoint(ckpt, abstract_train_state(model), device=dev,
                                       shardings=state_shardings(model, mesh14))
        out["k3_restore_s"] = time.perf_counter() - t0
        out["k3_mesh14_placements"] = sorted({str(tuple(t.placements)) for _p, t in tree_leaves(restored)})
        # each leaf whole on both meshes, compared on the card; rank 0 takes
        # the saved state's digests for the parent's one-rank restore
        from torch.distributed.tensor import distribute_tensor

        same, digests = True, {}
        for (path, a), (_q, b) in zip(tree_leaves(restored), tree_leaves(state)):
            whole = a.detach().full_tensor()  # the (1, 4) restore, whole; cut as the (2, 2) state is
            mine = distribute_tensor(whole, b.device_mesh, b.placements, src_data_rank=None).to_local()
            same = same and torch.equal(mine, b.detach().to_local())
            if rank == 0:
                digests.update(_digests({path: whole}))
        out["k3_mesh14_bits"], out["k3_digests"] = same, digests if rank == 0 else None
    return out


def path_k(card: str) -> list:
    """Path K (after path J): the sharded half on four ranks spawned on the
    one card over ``gloo_staged`` (``path_k_rank``), each phase's single-rank
    run here after the ranks exit.  K1: Moonlight's prefill and greedy
    decode on (1, 4) held at ``LM_BF16_REL`` against the single-rank run on
    the same weights, its expert choices replayed and its tokens forced,
    the flash launches per rank asserted; K2: RecurrentGemma-2B trained 3
    steps on (2, 2), its RG-LRU launches per rank asserted, its losses and
    gradient norms held at ``K2_LOSS_REL`` and every moment leaf at
    ``K2_MOMENT_REL`` against the single-rank steps (a control that leaves
    data rank 1's rows out must fail that gate), the step wall (max over
    ranks) and peak memory per rank; K3: the K2 checkpoint restored on
    (1, 4) and on one rank, bit for bit; K4: ``lower_cell`` of
    recurrentgemma-2b train_4k on the fake 16 x 16 mesh with fake CUDA
    tensors.  Returns the kernels' report rows of the ranks' shapes."""
    import gc
    import os
    import shutil

    import torch

    from repro_torch.checkpoint.store import load_checkpoint
    from repro_torch.core import codegen_cuda
    from repro_torch.data.pipeline import SyntheticLMDataset
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.rglru import ops as rglru_ops
    from repro_torch.kernels.rglru.ref import rglru_scan_ref
    from repro_torch.launch.dryrun import lower_cell
    from repro_torch.launch.ranks import run_ranks
    from repro_torch.models import build_model
    from repro_torch.models import moe as moe_mod
    from repro_torch.runtime.loop import abstract_train_state, init_train_state, make_train_step

    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    outdir = ROOT / ".gt_cache_torch" / "path_k"
    shutil.rmtree(outdir, ignore_errors=True)
    outdir.mkdir(parents=True)
    for kern in (flash_ops.KERNEL_BF16, rglru_ops.KERNEL):  # built here (phase 2 has, in a whole run): the ranks load
        kern.start_build()
    for kern in (flash_ops.KERNEL_BF16, rglru_ops.KERNEL):
        kern.finish_build()
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")  # the ranks' allocators
    ranks = run_ranks(path_k_rank, 4, (str(outdir),), store_dir=outdir, backend="gloo_staged", timeout=K_TIMEOUT)
    r0 = ranks[0]
    log(f"path K ranks (spawn to exit): {time.perf_counter() - t_phase:.1f} s -- {card}")

    # ---- K1 against the single-rank run on the same weights
    cfg = _k_cfg("k1")
    want_flash = K1_LAYERS
    for r in ranks:
        got = r["k1_prefill_launches"].get("flash_fwd_sm90", 0)
        others = {k: v for k, v in r["k1_prefill_launches"].items() if k != "flash_fwd_sm90" and v}
        if got != want_flash or others or any(r["k1_decode_launches"].values()):
            raise AssertionError(f"K1 rank {r['rank']}: prefill launches {r['k1_prefill_launches']} (want "
                                 f"{want_flash} of flash_fwd_sm90 only), decode {r['k1_decode_launches']} (want none)")
        if r["k1_flash_calls"] != want_flash:
            raise AssertionError(f"K1 rank {r['rank']}: {r['k1_flash_calls']} flash calls held, want {want_flash}")
    rec = torch.load(outdir / "k1.pt")
    model = build_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(K_SEED), device=dev)
    replay = iter(rec["choices"])
    orig_top_k = moe_mod._top_k

    def replayed(probs, k):
        idx = next(replay).to(device=probs.device, dtype=torch.int64)
        return torch.gather(probs, -1, idx), idx

    moe_mod._top_k = replayed
    try:
        with torch.no_grad():
            cache = model.make_cache(K1_BATCH, K1_PROMPT + K1_STEPS + H_SLACK, device=dev)
            codegen_cuda.reset_launch_counts()
            logits, cache = model.prefill(params, {"tokens": _k_prompt(cfg.vocab).to(dev)}, cache)
            single = [logits.float().cpu()]
            for tok in rec["tokens"]:
                logits, cache = model.decode_step(params, {"tokens": tok.to(dev)}, cache)
                single.append(logits.float().cpu())
        if next(replay, None) is not None:
            raise AssertionError("K1: the single-rank run made fewer MoE calls than the ranks")
    finally:
        moe_mod._top_k = orig_top_k
    rels = [float((a - b).abs().max() / b.abs().max()) for a, b in zip(rec["logits"], single)]
    log(f"K1 {K1_ARCH} {K1_LAYERS} layers bf16 on {K1_MESH}: logits against the single-rank run, max |diff| / max "
        f"|logit| per call (prefill, {K1_STEPS} decode steps) {[f'{x:.3e}' for x in rels]} (gate {LM_BF16_REL}); "
        f"prefill {max(r['k1_prefill_s'] for r in ranks):.3f} s, decode {max(r['k1_decode_s'] for r in ranks):.3f} "
        f"s a step (max over ranks); flash {want_flash} launches a rank, max |kernel - plain| "
        f"{max(r['k1_flash_err'] for r in ranks):.3e}; weights {r0['k1_param_bytes'] / 1e9:.2f} GB a rank, peak "
        f"{max(r['k1_peak_gb'] for r in ranks):.2f} GB -- {card}")
    if not max(rels) <= LM_BF16_REL:
        raise AssertionError(f"K1: the sharded logits stray {max(rels):.3e} of the largest from the single rank's")
    del params, cache, logits, single, rec
    gc.collect()
    torch.cuda.empty_cache()
    t_k1 = time.perf_counter()

    # ---- K2 against the single-rank steps; K3 on one rank
    cfg = _k_cfg("k2")
    want_scans = _k2_rglru_launches(cfg)
    for r in ranks:
        got = r["k2_launches"].get("rglru_scan", 0)
        if got != want_scans or any(v for k, v in r["k2_launches"].items() if k != "rglru_scan"):
            raise AssertionError(f"K2 rank {r['rank']}: launches {r['k2_launches']}, want {want_scans} rglru_scan")
        if any(e != 0 for e in r["k2_scan_err"]) or len(r["k2_scan_err"]) != K2_SCAN_CHECKS:
            raise AssertionError(f"K2 rank {r['rank']}: RG-LRU kernel against the plain loop {r['k2_scan_err']}")
        if not r["k3_mesh14_bits"]:
            raise AssertionError(f"K3 rank {r['rank']}: the (1, 4) restore differs from the saved state")
    model = build_model(cfg)
    state = init_train_state(model, torch.Generator().manual_seed(K_SEED), device=dev)
    step_fn = make_train_step(model, base_lr=K2_LR, warmup_steps=K2_WARMUP, total_steps=100, microbatches=K2_MICRO)
    ds = SyntheticLMDataset(vocab=cfg.vocab, seq_len=K2_SEQ, global_batch=K2_BATCH)
    torch.cuda.reset_peak_memory_stats()
    losses, gnorms, walls = [], [], []
    for step in range(K2_STEPS):
        b = _k2_batch(ds, step, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, b)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
        gnorms.append(float(metrics["grad_norm"]))
    single_peak = torch.cuda.max_memory_allocated() / 1e9
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(r0["k2_losses"], losses))
    gnorm_rel = max(abs(a - b) / abs(b) for a, b in zip(r0["k2_gnorms"], gnorms))
    _s, restored = load_checkpoint(outdir / "k2_ckpt", abstract_train_state(model), device=dev)
    alone = _digests(restored) == r0["k3_digests"]
    gap, gap_leaf = _moment_gap(restored.opt, state.opt)
    single_opt = state.opt
    del state, restored
    gc.collect()
    torch.cuda.empty_cache()
    # the control: the same steps with data rank 1's rows (1 and 3: the second
    # of each microbatch) left out of the loss, as if that rank's gradient were lost
    ctrl = init_train_state(model, torch.Generator().manual_seed(K_SEED), device=dev)
    for step in range(K2_STEPS):
        b = _k2_batch(ds, step, dev)
        b["labels"][1::2] = -1
        ctrl, _m = step_fn(ctrl, b)
    ctrl_gap, ctrl_leaf = _moment_gap(ctrl.opt, single_opt)
    step_walls = [max(r["k2_walls"][i] for r in ranks) for i in range(K2_STEPS)]
    log(f"K2 {K2_ARCH} {K2_LAYERS} layers on {K2_MESH}, {K2_STEPS} steps of {K2_BATCH} x {K2_SEQ} ({K2_MICRO} "
        f"microbatches): losses {[f'{x:.6f}' for x in r0['k2_losses']]} (single rank {[f'{x:.6f}' for x in losses]}, "
        f"max rel {loss_rel:.3e}, gate {K2_LOSS_REL}); grad norms {[f'{x:.4f}' for x in r0['k2_gnorms']]} (single "
        f"rank {[f'{x:.4f}' for x in gnorms]}, max rel {gnorm_rel:.3e}); moments max ||sharded - single|| / "
        f"||single|| {gap:.4e} at {gap_leaf} (gate {K2_MOMENT_REL}; the control, data rank 1's rows left out, "
        f"{ctrl_gap:.4e} at {ctrl_leaf}); step wall {[f'{x:.3f}' for x in step_walls]} s (max over "
        f"ranks; single rank {[f'{x:.3f}' for x in walls]} s); peak memory a rank "
        f"{[round(r['k2_peak_gb'], 2) for r in ranks]} GB (single rank {single_peak:.2f} GB); {want_scans} RG-LRU "
        f"launches a rank, {K2_SCAN_CHECKS} held to the plain loop's bits -- {card}")
    log(f"K3: the K2 checkpoint (saved on {K2_MESH} in {r0['k3_save_s']:.1f} s) restored on (1, 4) in "
        f"{r0['k3_restore_s']:.1f} s: bit for bit {all(r['k3_mesh14_bits'] for r in ranks)}, placements "
        f"{r0['k3_mesh14_placements'][:3]}...; on one rank: bit for bit {alone}")
    if not (loss_rel <= K2_LOSS_REL and gnorm_rel <= K2_LOSS_REL and gap <= K2_MOMENT_REL):
        raise AssertionError(f"K2: losses {loss_rel:.3e}, grad norms {gnorm_rel:.3e} (gate {K2_LOSS_REL}), moments "
                             f"{gap:.3e} at {gap_leaf} (gate {K2_MOMENT_REL}) from the single-rank steps")
    if not ctrl_gap > K2_MOMENT_REL:
        raise AssertionError(f"K2: the control (data rank 1's rows left out) passes the moment gate: {ctrl_gap:.3e}")
    if not alone:
        raise AssertionError("K3: the checkpoint restored on one rank differs from the ranks' state")
    del ctrl, single_opt, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    t_k2 = time.perf_counter()

    # ---- K4: one dry-run cell on the fake 16 x 16 mesh, fake CUDA tensors
    rep = lower_cell("recurrentgemma-2b", "train_4k", False, device="cuda")
    mem = rep["memory"]
    log(f"K4 dry run recurrentgemma-2b train_4k on 16 x 16 (fake CUDA tensors): "
        f"{mem['total_per_device_bytes'] / 2**30:.2f} GiB a rank (arguments {mem['argument_bytes'] / 2**30:.2f}, "
        f"temporaries {mem['temp_bytes'] / 2**30:.2f}), {rep['cost']['flops']:.4e} flops a rank, collectives "
        f"{ {k: f'{v['bytes']:.4e} B in {v['count']}' for k, v in rep['collectives'].items()} }, link bytes "
        f"{rep['collective_link_bytes']:.4e} ({rep['lower_compile_s']} s)")

    # ---- the ranks' kernel shapes, timed here beside their plain versions, SDPA and their bounds
    rows = []
    gen = torch.Generator(device=dev)
    gen.manual_seed(61)
    hd, h = 128, 16
    rows_a_rank = K1_PROMPT // K1_MESH[1]
    off = K1_PROMPT - rows_a_rank  # the last rank's rows: the most keys
    q = torch.randn((K1_BATCH, rows_a_rank, h, hd), generator=gen, device=dev).to(torch.bfloat16)
    k, v = (torch.randn((K1_BATCH, K1_PROMPT, h, hd), generator=gen, device=dev).to(torch.bfloat16) for _ in range(2))
    launch = flash_ops.prepare(q, k, v, causal=True, q_offset=off)
    ms = cuda_ms(launch, iters=10)
    ref = flash_attention_ref(q, k, v, causal=True, q_offset=off)
    err = float((launch().float() - ref.float()).abs().max())
    plain_ms = cuda_ms(lambda: flash_attention_ref(q, k, v, causal=True, q_offset=off), iters=1, warmup=1)
    qpos = off + torch.arange(rows_a_rank, device=dev)[:, None]
    mask = torch.arange(K1_PROMPT, device=dev)[None, :] <= qpos
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    lib_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask), iters=10)
    flops = 4 * hd * int(mask.sum()) * K1_BATCH * h
    nbytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel())
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / HBM_BYTES_PER_S
    bound_ms, bound_by = max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")
    n = sum(r["k1_prefill_launches"].get("flash_fwd_sm90", 0) for r in ranks)
    log(f"time flash_attention.{K1_ARCH}.k1_rank_rows q {tuple(q.shape)} kv {tuple(k.shape)} q_offset {off}: kernel "
        f"{ms:.4f} ms, plain torch {plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); "
        f"max_abs_err {err:.3e}; launches on path K {n} ({want_flash} a rank) -- {card}")
    rows.append({"name": f"flash_attention.{K1_ARCH}.k1_rank_rows", "route": "cuda",
                 "source": "src/repro_torch/kernels/flash_attention/csrc/flash_fwd_sm90.cu",
                 "replaces": "src/repro/kernels/flash_attention/kernel.py:153", "launches": n, "max_abs_err": err,
                 "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
                 "model": K1_ARCH, "model_dtype": "bfloat16", "path": "K"})
    del q, k, v, qt, kt, vt, mask, ref, launch
    shape = (K2_BATCH // K2_MESH[0] // K2_MICRO, K2_SEQ, cfg.rglru.d_rnn // K2_MESH[1])
    a = 0.5 + 0.499 * torch.rand(shape, generator=gen, device=dev)
    b, h0 = (torch.randn(s, generator=gen, device=dev) for s in (shape, (shape[0], shape[2])))
    launch = rglru_ops.prepare(a, b, None)
    ms = cuda_ms(launch, iters=20)
    err = float((launch() - rglru_scan_ref(a, b, None)).abs().max())
    plain_ms = cuda_ms(lambda: rglru_scan_ref(a, b, None), iters=1, warmup=1)
    nbytes, flops = 4 * 3 * a.numel(), 2 * a.numel()
    t_ops, t_bytes = flops / PEAK_FLOPS["float32"], nbytes / HBM_BYTES_PER_S
    bound_ms, bound_by = max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")
    n = sum(r["k2_launches"].get("rglru_scan", 0) for r in ranks)
    log(f"time rglru_scan.{K2_ARCH}.k2_rank_channels {shape} float32: kernel {ms:.4f} ms, plain torch "
        f"{plain_ms:.4f} ms, no single PyTorch call, bound {bound_ms:.4f} ms ({bound_by}); max_abs_err {err:.3e}; "
        f"launches on path K {n} ({want_scans} a rank) -- {card}")
    if err != 0:
        raise AssertionError(f"rglru_scan at {shape}: the kernel differs from the plain loop by {err:.3e}")
    rows.append({"name": f"rglru_scan.{K2_ARCH}.k2_rank_channels", "route": "cuda",
                 "source": "src/repro_torch/kernels/rglru/csrc/rglru_scan.cu",
                 "replaces": "src/repro/kernels/rglru/kernel.py:62", "launches": n, "max_abs_err": err, "ms": ms,
                 "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
                 "model": K2_ARCH, "model_dtype": "bfloat16", "path": "K"})
    del a, b, h0, launch
    torch.cuda.empty_cache()
    now = time.perf_counter()
    log(f"path K wall: ranks and K1 {t_k1 - t_phase:.1f} s, K2 and K3 {t_k2 - t_k1:.1f} s, K4 and times "
        f"{now - t_k2:.1f} s")
    return rows


def paths_a_to_g():
    """Phases 1-5 for paths A-G. Returns the kernels' report rows, the phases'
    walls and the card's name and power limit; what the paths held is freed
    when this returns."""
    import torch
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
    from repro_torch.program.compile import DistributedStepPlan
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
    # path I's distributed program (its groups are climate_step_dist_g*) at
    # the rank's 256 x 256 x 80 tile, one-member and member-batched: built
    # here with the rest, so that no rank runs nvcc
    dist_plan = DistributedStepPlan(prog, {n: torch.empty(DIST_LOCAL, dtype=torch.float64, device="meta")
                                           for n in names}, scalars, DIST_LOCAL, {})
    dist_kernels = [o.kernel for o in dist_plan.group_objects]
    dist_kernels += [o.block_kernel(None, ()) for o in dist_plan.group_objects]
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
    kernels += variants + dist_kernels
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

    # path C: LM serving, phi3-mini-3.8b at full width (depth LM_LAYERS), random weights
    lm_cfg = dataclasses.replace(lm_full, attention_impl="flash", n_layers=LM_LAYERS)
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
    log(f"path lm_serve: {LM_ARCH} ({lm_cfg.n_layers} of {lm_full.n_layers} layers, d_model {lm_cfg.d_model}, {lm_cfg.n_heads} heads, "
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
    bound = stencil_bound

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
    return report, walls, card, iter_ms


def path_i_arrays(domain):
    """Path I's global interior fields, seeded with numpy: a gaussian tracer
    with noise, steady winds, a random w, zeros elsewhere."""
    import numpy as np

    from repro_torch.stencils import climate

    ni, nj, nk = domain
    g = np.random.default_rng(5)
    xx, yy = np.meshgrid(np.linspace(-2, 2, ni), np.linspace(-2, 2, nj), indexing="ij")
    out = {n: np.zeros(domain) for n in climate.FIELD_NAMES}
    out["phi"] = np.exp(-(xx**2 + yy**2))[:, :, None] * np.ones((1, 1, nk)) + 1e-2 * g.normal(size=domain)
    out["u"] = np.full(domain, 0.8)
    out["v"] = np.full(domain, -0.4)
    out["w"] = 0.2 * g.random(domain)
    return out


def path_i_members(domain):
    """The ensemble's fields (``path_i_arrays``) and its members' initial
    tracers: the base tracer plus 1e-3 of seeded noise each."""
    import numpy as np

    base = path_i_arrays(domain)
    noise = np.random.default_rng(11).normal(size=(DIST_MEMBERS,) + tuple(domain))
    return base, base["phi"][None] + 1e-3 * noise


def path_i_rank(rank: int, world: int, store: str) -> dict:
    """Path I on one of the four ranks that share the card (``launch.ranks``
    runs it in each): the distributed climate program (10 calls, then
    ``iterate(10)``), the eager chain of DistributedStencils, hdiff, and the
    ensemble over members x domain; each held, on this rank's block, against
    the single-domain runs ``path_i`` saved in ``store``.  Returns what the
    parent checks and prints."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.core import codegen_cuda, storage
    from repro_torch.kernels.hdiff import ops as hdiff_ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel import halo
    from repro_torch.stencils import climate
    from repro_torch.stencils.distributed import DistributedStencil

    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    store = Path(store)
    scalars = dict(climate.DEFAULT_SCALARS)
    out = {"rank": rank}
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def on_card(block):
        t = storage.card_tensor(block.shape, torch.float64, dev)
        t.copy_(block)
        return t

    def saved(name, mesh, member_axis=None):
        """This rank's block of a single-domain result ``path_i`` saved."""
        whole = torch.from_numpy(np.load(store / f"{name}.npy", mmap_mode="c"))
        return halo.shard_blocks(whole, mesh, member_axis=member_axis)

    def deviation(t, ref):
        return float((t.cpu() - ref).abs().max())

    def timed(fn):
        torch.cuda.synchronize()
        dist.barrier()  # the ranks start together
        start.record()
        result = fn()
        end.record()
        torch.cuda.synchronize()
        return result, start.elapsed_time(end)

    mesh = make_mesh(DIST_MESH, ("data", "model"))
    blocks = {n: halo.shard_blocks(torch.from_numpy(a), mesh) for n, a in path_i_arrays(DIST_GLOBAL).items()}

    def fresh():
        return {n: on_card(b) for n, b in blocks.items()}

    st = climate.build_stencils("cuda")
    dp = climate.build_program("cuda", DIST_LOCAL, stencils=st, name="climate_step").distribute(mesh)
    fc, fi = fresh(), fresh()
    groups = dp.plan(fc, scalars).group_objects

    # the program: 10 calls, then iterate(10) from the same start
    def calls():
        for _ in range(NSTEPS):
            o = dp(fc, scalars)
            fc["phi"], fc["phi_new"] = o["phi"], o["phi_new"]

    dp(fresh(), scalars)  # a first call binds the padded and pinned buffers and the launchers: not timed
    codegen_cuda.reset_launch_counts()
    halo.reset_message_counts()
    _none, ms = timed(calls)
    out["call_ms"] = ms / NSTEPS
    info = {}
    final, ms = timed(lambda: dp.iterate(NSTEPS, fi, scalars, exec_info=info))
    out["iterate_ms"] = ms / NSTEPS
    out["program_launches"] = [g.launches for g in groups]
    out["program_stencil_launches"] = sum(s.launches for s in st.values())
    out["program_all_launches"] = sum(codegen_cuda.launch_counts().values())
    out["program_messages"] = halo.message_counts()
    out["report"], out["timings"] = info["program_report"], info["rank_timings"]
    out["iterate_equals_calls"] = bool(torch.equal(final["phi"], fc["phi"]))
    out["program_err"] = deviation(fc["phi"], saved("program", mesh))
    # the exchange alone, 20 in a row with no kernel between: the staged transport's own cost
    padded = halo.padded_like(fc["phi"], 1, card=True)
    _none, ms = timed(lambda: [dp.exchange.fill(padded, 1) for _ in range(20)])
    out["exchange_alone_ms"] = ms / 20

    # the eager chain: one DistributedStencil a stencil, each exchanging every field it takes
    dst = {n: DistributedStencil(s, mesh) for n, s in st.items()}
    fe = fresh()
    codegen_cuda.reset_launch_counts()
    halo.reset_message_counts()
    _none, ms = timed(lambda: [climate.distributed_eager_step(dst, fe, scalars) for _ in range(NSTEPS)])
    out["eager_ms"] = ms / NSTEPS
    out["eager_launches"] = {n: s.launches for n, s in st.items()}
    out["eager_all_launches"] = sum(codegen_cuda.launch_counts().values())
    out["eager_messages"] = halo.message_counts()
    out["calls_equal_eager"] = bool(torch.equal(fc["phi"], fe["phi"]))
    del fc, fi, fe, final

    # hdiff on the rank's block
    hd = hdiff_ops.stencil_object("float64")
    dh = DistributedStencil(hd, mesh)
    x = on_card(blocks["phi"])
    codegen_cuda.reset_launch_counts()
    halo.reset_message_counts()
    smoothed, _ms = timed(lambda: dh({"in_phi": x, "out_phi": torch.zeros_like(x)}, {"alpha": HDIFF_ALPHA}))
    out["hdiff_launches"] = hd.launches
    out["hdiff_all_launches"] = sum(codegen_cuda.launch_counts().values())
    out["hdiff_messages"] = halo.message_counts()
    out["hdiff_err"] = deviation(smoothed["out_phi"], saved("hdiff", mesh))
    del blocks, x, smoothed

    # the ensemble: 4 members over "ens", tiles over (data, model); u, v, w shared
    emesh = make_mesh(DIST_ENS_MESH, ("ens", "data", "model"))
    base, members = path_i_members(DIST_ENS_GLOBAL)
    eprog = climate.build_program("cuda", DIST_LOCAL, stencils=st, name="climate_step")
    dens = eprog.ensemble(DIST_MEMBERS).distribute(emesh, member_axis="ens")
    ef = {}
    for n, a in base.items():
        if n == "phi":
            ef[n] = on_card(halo.shard_blocks(torch.from_numpy(members), emesh, member_axis="ens"))
        elif n in ("u", "v", "w"):
            ef[n] = on_card(halo.shard_blocks(torch.from_numpy(a), emesh))
        else:
            ef[n] = storage.card_tensor((dens.local_members,) + DIST_LOCAL, torch.float64, dev, "zeros")
    del base, members
    egroups = dens.dp.plan({n: (t[0] if t.dim() == 4 else t) for n, t in ef.items()}, scalars).group_objects
    codegen_cuda.reset_launch_counts()
    halo.reset_message_counts()
    info = {}
    efinal, ms = timed(lambda: dens.iterate(NSTEPS, ef, scalars, exec_info=info))
    out["ens_ms"] = ms / NSTEPS
    out["ens_launches"] = [g.block_kernel(None, ()).launches for g in egroups]
    out["ens_one_member_launches"] = sum(g.launches for g in egroups)
    out["ens_all_launches"] = sum(codegen_cuda.launch_counts().values())
    out["ens_messages"] = halo.message_counts()
    out["ens_report"], out["ens_timings"] = info["ensemble_report"], info["rank_timings"]
    out["members_err"] = deviation(efinal["phi"], saved("members", emesh, "ens"))
    dist.barrier()
    return out


def path_i(card: str, path_e_ms: float) -> list:
    """Path I: the distributed stencil path, four ranks on the one card over
    gloo (``path_i_rank``), held against single-domain runs on the card;
    returns the kernels' report rows of the path."""
    import numpy as np
    import torch

    from repro_torch.core import storage
    from repro_torch.kernels.hdiff import ops as hdiff_ops
    from repro_torch.launch.ranks import run_ranks
    from repro_torch.program.compile import DistributedStepPlan
    from repro_torch.stencils import climate

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    store = ROOT / ".gt_cache_torch" / "path_i"
    store.mkdir(parents=True, exist_ok=True)
    scalars = dict(climate.DEFAULT_SCALARS)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def padded(a):
        """``a`` in a zero halo of depth H, a storage on the card."""
        return storage.from_array(np.pad(a, ((H, H), (H, H), (0, 0))), backend="cuda", default_origin=(H, H, 0))

    # the single-domain runs on the card the ranks are held against: the
    # program over the zero-padded 518 x 518 x 80 domain, hdiff on the same
    # padded tracer, and each ensemble member alone at 262 x 518 x 80
    glob = path_i_arrays(DIST_GLOBAL)
    f = {n: padded(a) for n, a in glob.items()}
    prog = climate.build_program("cuda", DIST_GLOBAL, name="climate_step")
    prog.compiled(f, scalars)  # traced and compiled before the timed calls
    torch.cuda.synchronize()
    start.record()
    for _ in range(NSTEPS):
        prog(**f, **scalars)
    end.record()
    torch.cuda.synchronize()
    single_ms = start.elapsed_time(end) / NSTEPS
    np.save(store / "program.npy", f["phi"].to_numpy()[H:-H, H:-H])
    smoothed = hdiff_ops.hdiff(torch.from_numpy(np.pad(glob["phi"], ((H, H), (H, H), (0, 0)))).to(dev), HDIFF_ALPHA)
    np.save(store / "hdiff.npy", smoothed[H:-H, H:-H].cpu().numpy())
    base, members = path_i_members(DIST_ENS_GLOBAL)
    eprog = climate.build_program("cuda", DIST_ENS_GLOBAL, name="climate_step")
    refs = []
    for m in range(DIST_MEMBERS):
        fm = {n: padded(members[m] if n == "phi" else a) for n, a in base.items()}
        eprog.iterate(NSTEPS, **fm, **scalars)
        refs.append(fm["phi"].to_numpy()[H:-H, H:-H])
    np.save(store / "members.npy", np.stack(refs))
    del f, glob, smoothed, base, members, fm, refs
    torch.cuda.empty_cache()
    t_refs = time.perf_counter() - t0

    t1 = time.perf_counter()
    world = DIST_MESH[0] * DIST_MESH[1]
    res = run_ranks(path_i_rank, world, (str(store),), store_dir=store, backend="gloo", timeout=DIST_TIMEOUT)
    t_ranks = time.perf_counter() - t1
    for name in ("program", "hdiff", "members"):
        (store / f"{name}.npy").unlink()

    r0 = res[0]
    plan = r0["report"]["halo_plan"]
    inserted = plan["inserted"]
    log(f"path distributed: {world} ranks on one card over gloo (stripes staged through pinned host memory), "
        f"mesh {DIST_MESH} ('data', 'model') over {DIST_GLOBAL} float64, {DIST_LOCAL} a rank; groups "
        f"{r0['report']['group_stencils']}, eliminated temporaries {r0['report']['eliminated_temporaries']}; "
        f"halo plan {plan}")
    bad = []
    for r in res:
        rk = f"rank {r['rank']}"
        if r["program_launches"] != [2 * NSTEPS] * len(r["program_launches"]) or r["program_stencil_launches"]:
            bad.append(f"{rk}: program launches {r['program_launches']}, per-stencil {r['program_stencil_launches']}")
        if r["program_all_launches"] != sum(r["program_launches"]):
            bad.append(f"{rk}: {r['program_all_launches']} launches in all during the program")
        if r["program_messages"]["exchanges"] != inserted * 2 * NSTEPS:
            bad.append(f"{rk}: {r['program_messages']['exchanges']} exchanges in {2 * NSTEPS} steps, plan {inserted}")
        if set(r["eager_launches"].values()) != {NSTEPS} or r["eager_all_launches"] != 5 * NSTEPS:
            bad.append(f"{rk}: eager chain launches {r['eager_launches']} ({r['eager_all_launches']} in all)")
        if r["eager_messages"]["exchanges"] != plan["baseline_per_step"] * NSTEPS:
            bad.append(f"{rk}: eager chain {r['eager_messages']['exchanges']} exchanges, baseline "
                       f"{plan['baseline_per_step']} a step")
        if r["hdiff_launches"] != 1 or r["hdiff_all_launches"] != 1:
            bad.append(f"{rk}: hdiff launches {r['hdiff_launches']} ({r['hdiff_all_launches']} in all)")
        if (r["ens_launches"] != [NSTEPS] * len(r["ens_launches"]) or r["ens_one_member_launches"]
                or r["ens_all_launches"] != sum(r["ens_launches"])):
            bad.append(f"{rk}: ensemble launches {r['ens_launches']}, one-member {r['ens_one_member_launches']}")
        if r["ens_messages"]["exchanges"] != r["ens_report"]["program_report"]["halo_plan"]["inserted"] * NSTEPS:
            bad.append(f"{rk}: ensemble exchanges {r['ens_messages']}")
        if not (r["calls_equal_eager"] and r["iterate_equals_calls"]):
            bad.append(f"{rk}: calls == eager chain {r['calls_equal_eager']}, iterate == calls "
                       f"{r['iterate_equals_calls']}")
    errs = {k: max(r[k] for r in res) for k in ("program_err", "hdiff_err", "members_err")}
    log(f"distributed: launches a rank {r0['program_launches']} in {NSTEPS} calls and iterate({NSTEPS}) (two a "
        f"step, none of the five per-stencil kernels), exchanges a rank {r0['program_messages']} ({inserted} a "
        f"step); eager chain {r0['eager_launches']}, exchanges {r0['eager_messages']} "
        f"({plan['baseline_per_step']} a step); hdiff {r0['hdiff_launches']} launch, {r0['hdiff_messages']}")
    log(f"distributed: calls == eager chain bit for bit and iterate == calls on every rank: "
        f"{all(r['calls_equal_eager'] and r['iterate_equals_calls'] for r in res)}; max deviation from the "
        f"single-domain program over the zero-padded {DIST_GLOBAL[0] + 2 * H} x {DIST_GLOBAL[1] + 2 * H} x "
        f"{DIST_GLOBAL[2]} domain {errs['program_err']:.3e}, hdiff from ops.hdiff {errs['hdiff_err']:.3e}, "
        f"ensemble members from their single-domain runs {errs['members_err']:.3e} (atol 1e-12)")
    er = r0["ens_report"]
    log(f"distributed ensemble: {er['members']} members on mesh {DIST_ENS_MESH} ('ens', 'data', 'model') over "
        f"{DIST_ENS_GLOBAL}, {er['members_per_shard']} a rank; launches a rank {r0['ens_launches']} (one a group "
        f"and step for both members), exchanges {r0['ens_messages']} (one a buffer and step carries both)")
    if bad or not max(errs.values()) <= 1e-12:
        raise AssertionError(f"distributed path: {bad}, deviations {errs}")

    def worst(key, field):
        return max(r[key][field] / r[key]["steps"] * 1e3 for r in res)

    log(f"time distributed step {DIST_GLOBAL} float64 on {world} ranks sharing one card (CUDA events, max over "
        f"ranks): iterated step {worst('timings', 'seconds'):.4f} ms, its {inserted} exchanges "
        f"{worst('timings', 'exchange_seconds'):.4f} ms, its group kernels {worst('timings', 'groups_seconds'):.4f} "
        f"ms; an exchange alone (20 in a row, no kernel between) {max(r['exchange_alone_ms'] for r in res):.4f} ms; "
        f"a call {max(r['call_ms'] for r in res):.4f} ms, eager chain {max(r['eager_ms'] for r in res):.4f} ms "
        f"a step; single-domain program at {DIST_GLOBAL} {single_ms:.4f} ms a call; path E's step at {DOMAIN} "
        f"{path_e_ms:.4f} ms -- {card}")
    log(f"time distributed ensemble {DIST_MEMBERS} x {DIST_ENS_GLOBAL} float64 (CUDA events, max over ranks): "
        f"step {worst('ens_timings', 'seconds'):.4f} ms, exchanges {worst('ens_timings', 'exchange_seconds'):.4f} "
        f"ms, group kernels {worst('ens_timings', 'groups_seconds'):.4f} ms -- {card}")
    log(f"path I wall: single-domain runs {t_refs:.1f} s, ranks (spawn to exit) {t_ranks:.1f} s")

    # the path's kernels at the rank's tile, timed here with the card to
    # themselves: each distributed group one-member and member-batched (the
    # buffers the plan exchanges padded to its depth), and hdiff
    lprog = climate.build_program("cuda", DIST_LOCAL, name="climate_step")
    dplan = DistributedStepPlan(lprog, {n: torch.empty(DIST_LOCAL, dtype=torch.float64, device="meta")
                                        for n in climate.FIELD_NAMES}, scalars, DIST_LOCAL, {})
    sc = {**dplan.const_scalars, **scalars}
    d = dplan.depth
    gen = torch.Generator(device=dev).manual_seed(3)
    shared = ("u", "v", "w")

    def tile_fields(obj, members=None):
        out = {}
        for n in obj.field_info:
            shape = (DIST_LOCAL[0] + 2 * d, DIST_LOCAL[1] + 2 * d, DIST_LOCAL[2])
            if members is not None and n not in shared:
                shape = (members,) + shape
            t = storage.card_tensor(shape, torch.float64, dev)
            if n in ("u", "v"):
                t.fill_(0.8 if n == "u" else -0.4)
            elif n == "w":
                t.copy_(0.2 * torch.rand(shape, generator=gen, device=dev, dtype=torch.float64))
            else:
                t.copy_(torch.randn(shape, generator=gen, device=dev, dtype=torch.float64))
            out[n] = t
        return out

    def kernel_vs_plain(launch, plain, fields, written):
        """(kernel ms, plain ms, max |kernel - plain| of the written fields)."""
        before = {n: t.clone() for n, t in fields.items()}
        plain()
        want = {n: fields[n].clone() for n in written}
        for n, t in before.items():
            fields[n].copy_(t)
        launch()
        torch.cuda.synchronize()
        err = max(float((fields[n] - want[n]).abs().max()) for n in written)
        return cuda_ms(launch, iters=50), cuda_ms(plain, iters=3), err

    rows = []
    members = r0["ens_report"]["members_per_shard"]
    for gi, obj in enumerate(dplan.group_objects):
        name = "+".join(n.replace("_defs", "") for n in r0["report"]["group_stencils"][gi])
        origins = {n: (d, d, 0) for n in obj.field_info}
        written = sorted(set(obj.implementation_ir.written_api_fields()))
        fields = tile_fields(obj)
        ms, plain_ms, err = kernel_vs_plain(obj.kernel.prepare(fields, sc, DIST_LOCAL, origins),
                                            lambda: obj._run(fields, sc, DIST_LOCAL, origins), fields, written)
        bound_ms, bound_by, nbytes, _f = stencil_bound(obj, DIST_LOCAL)
        log(f"time distributed group {gi} [{name}] {DIST_LOCAL} float64 (haloed to depth {d}): kernel {ms:.4f} ms, "
            f"plain torch {plain_ms:.4f} ms, no single PyTorch call, bound {bound_ms:.4f} ms ({bound_by}: "
            f"{nbytes / 1e6:.1f} MB); max |kernel - plain| {err:.3e} -- {card}")
        rows.append({"name": f"distributed_program.{name}", "route": "cuda",
                     "source": "src/repro_torch/core/codegen_cuda.py",
                     "replaces": "src/repro/core/codegen_pallas.py:123", "launches": r0["program_launches"][gi],
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": None, "ranks": world})
        fields = tile_fields(obj, members)
        batched = obj.block_kernel(None, ())

        def plain_members(obj=obj, fields=fields, origins=origins):
            for m in range(members):
                obj._run({n: (t if n in shared else t[m]) for n, t in fields.items()}, sc, DIST_LOCAL, origins)

        ms, plain_ms, err = kernel_vs_plain(batched.prepare(fields, sc, DIST_LOCAL, origins, members=members),
                                            plain_members, fields, written)
        bound_ms, bound_by, nbytes, _f = stencil_bound(obj, DIST_LOCAL, members, shared)
        log(f"time distributed member-batched group {gi} [{name}] {members} x {DIST_LOCAL} float64: kernel "
            f"{ms:.4f} ms, plain torch member by member {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
            f"{nbytes / 1e6:.1f} MB); max |kernel - plain| {err:.3e} -- {card}")
        rows.append({"name": f"distributed_ensemble.{name}", "route": "cuda",
                     "source": "src/repro_torch/core/codegen_cuda.py",
                     "replaces": "src/repro/core/codegen_pallas.py:123", "launches": r0["ens_launches"][gi],
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": None, "ranks": world, "members": members})
        del fields
    hd = hdiff_ops.stencil_object("float64")
    hshape = (DIST_LOCAL[0] + 2 * H, DIST_LOCAL[1] + 2 * H, DIST_LOCAL[2])
    fields = {n: storage.card_tensor(hshape, torch.float64, dev) for n in ("in_phi", "out_phi")}
    fields["in_phi"].copy_(torch.randn(hshape, generator=gen, device=dev, dtype=torch.float64))
    fields["out_phi"].zero_()
    horig = {n: (H, H, 0) for n in fields}
    ms, plain_ms, err = kernel_vs_plain(hd.kernel.prepare(fields, {"alpha": HDIFF_ALPHA}, DIST_LOCAL, horig),
                                        lambda: hd._run(fields, {"alpha": HDIFF_ALPHA}, DIST_LOCAL, horig),
                                        fields, ["out_phi"])
    bound_ms, bound_by, nbytes, _f = stencil_bound(hd, DIST_LOCAL)
    log(f"time distributed hdiff {DIST_LOCAL} float64: kernel {ms:.4f} ms, plain torch {plain_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}: {nbytes / 1e6:.1f} MB); max |kernel - plain| {err:.3e} -- {card}")
    rows.append({"name": "distributed_hdiff", "route": "cuda", "source": "src/repro_torch/core/codegen_cuda.py",
                 "replaces": "src/repro/kernels/hdiff/ops.py:28", "launches": r0["hdiff_launches"],
                 "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                 "library_ms": None, "ranks": world})
    for row in rows:
        if not row["max_abs_err"] <= 1e-12:
            raise AssertionError(f"{row['name']}: the kernel differs from its plain version by {row['max_abs_err']}")
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_arch

    report, walls, card, path_e_ms = paths_a_to_g()
    # path I: its ranks share the card and exit before path H
    torch.cuda.empty_cache()
    report += path_i(card, path_e_ms)
    walls.mark("path I")
    # path H runs after every earlier path's tensors are freed: Moonlight's
    # bf16 weights alone take 57.8 GB
    report += lm_families(torch.device("cuda"), card, {arch: get_arch(arch).full for arch, _p, _r in H_MODELS})
    walls.mark("path H and its times")
    # path J trains after path H has freed its tensors
    torch.cuda.empty_cache()
    report += path_j(torch.device("cuda"), card)
    walls.mark("path J")
    # path K: four ranks on the card, after path J has freed its tensors
    torch.cuda.empty_cache()
    report += path_k(card)
    walls.mark("path K")
    log(walls.line())
    log(f"card: {card}")
    print(json.dumps({"kernels": report}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--path-j-restart"]:  # path J's child process (see path_j_restart)
        sys.exit(path_j_restart(sys.argv[2]))
    sys.exit(main())
