"""The stencil toolchain's matrices through the generated kernels on a card,
and the load pipeline against the plain-load kernels.

Path M of ``chip_smoke.py`` as tests: every corpus program at
``block=(4, 4)`` and opt levels 0, 3 and 1 or 2 (M1, within 1e-12), and
every case of ``tests/torch_stencil_cases.py`` at opt level 0 and the
default (M2, within 1e-13), each launched once on card-layout storages and
held against the port's ``debug`` backend at ``opt_level=0``.  The domains
are small and the block is (4, 4), so tile boundaries fall inside them.  A
failed build or launch fails the test.  The climate kernels whose PARALLEL
loops stream their inputs through the load pipeline (group 0, its
member-batched and distributed forms, the eager ``advect``, ``euler`` and
``diffuse``) give the plain-load kernel's bits (``async_staging=False``).

Needs a GPU and nvcc; skipped elsewhere.  This file imports neither JAX nor
the reference package:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_dsl_gpu.py
"""

import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch", reason="the torch port's tests need PyTorch")

import torch_stencil_cases as cases  # noqa: E402
from repro_torch.core.gtscript import FORWARD, PARALLEL, Field, computation, interval  # noqa: E402

pytestmark = pytest.mark.gpu

ROOT = Path(__file__).resolve().parents[1]
CORPUS_DIR = ROOT / "tests" / "corpus"
CORPUS = sorted(p.stem for p in CORPUS_DIR.glob("prog_*.json"))


@pytest.fixture(scope="module")
def built():
    """Every run of both matrices, its kernel compiled (``chip_smoke.build_all``: each source once, in parallel)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the generated kernels run only on the card")
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from chip_smoke import build_all

    corpus, rejected, expected = cases.corpus_runs(CORPUS_DIR)
    runs = corpus + cases.case_runs()
    build_all([r.stencil.kernel for r in runs])
    return {r.label: r for r in runs}, rejected, expected


def test_corpus_rejections_are_the_references(built):
    _runs, rejected, expected = built
    assert rejected == expected


@pytest.mark.parametrize("program", CORPUS)
def test_corpus_program_on_the_card(built, program):
    runs, rejected, _expected = built
    if program in rejected:
        return  # the reference's Pallas limit; test_corpus_rejections_are_the_references
    labels = [lab for lab in runs if lab.split("@")[0] == program]
    assert len(labels) == 3
    for lab in labels:
        cases.hold(runs[lab], torch.device("cuda"))


@pytest.mark.parametrize("case", [c.name for c in cases.CASES])
def test_case_on_the_card(built, case):
    runs, _rejected, _expected = built
    for lvl in ("0", "default"):
        cases.hold(runs[f"{case}@{lvl}"], torch.device("cuda"))


# ---------------------------------------------------------------------------
# the load pipeline against the plain-load kernel, bit for bit
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the generated kernels run only on the card")
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    return torch.device("cuda")


def _kernels(obj, members=None):
    """The pipelined kernel of ``obj``'s implementation and the plain-load
    one (``async_staging=False``), built."""
    from chip_smoke import build_all
    from repro_torch.core import caching, codegen_cuda

    out = []
    for staging in (True, False):
        fp = f"{obj.fingerprint}_{'pipe' if staging else 'plain'}{'_m' if members else ''}"
        module = caching.load_generated_module(obj.name, fp, codegen_cuda.generate_cuda_module_source(
            obj.implementation_ir, obj.kernel.module.BLOCK, staging, () if members else None))
        out.append(codegen_cuda.CudaKernel(module, caching.module_key(obj.name, fp), caching.cache_dir()))
    assert out[0].module.SCHEDULE["prefetch"] and not out[1].module.SCHEDULE["prefetch"]
    build_all(out)
    return out


def _card_fields(kernel, domain, origins, members=None, shared=(), seed=0):
    """Random float64 card-layout fields, each ``origins[name]`` deep below
    the domain and one to three points beyond it; ``shared`` fields without
    the member axis."""
    from repro_torch.core import storage

    ni, nj, nk = domain
    g = torch.Generator(device="cuda").manual_seed(seed)
    out = {}
    for name, _axes, dt, _written, _ext in kernel.module.FIELDS:
        oi, oj, ok = origins[name]
        lead = () if members is None or name in shared else (members,)
        shape = lead + (oi + ni + 2, oj + nj + 3, ok + nk)
        t = storage.card_tensor(shape, getattr(torch, dt), torch.device("cuda"))
        vals = torch.randn(shape, generator=g, device="cuda", dtype=torch.float64)
        out[name] = t.copy_(vals > 0 if dt == "bool" else vals)
    return out


def _same_bits(kernels, fields, scalars, domain, origins, members=None):
    """Launch both kernels on copies of ``fields``; every field must match bit for bit."""
    results = []
    for k in kernels:
        f = {n: t.clone() for n, t in fields.items()}
        k.prepare(f, scalars, domain, origins, members=members)()
        results.append(f)
    torch.cuda.synchronize()
    pipe, plain = results
    for n in fields:
        assert torch.equal(pipe[n], plain[n]), n
        if pipe[n].is_floating_point():
            assert float((pipe[n] - plain[n]).abs().max()) == 0.0, n
    written = [name for name, _axes, _dt, w, _ext in kernels[0].module.FIELDS if w]
    assert any(not torch.equal(pipe[n], fields[n]) for n in written)


def _climate_group(name):
    from repro_torch.core import storage
    from repro_torch.stencils import climate

    dom = (16, 16, 8)
    shape = (dom[0] + 2 * climate.HALO, dom[1] + 2 * climate.HALO, dom[2])
    f = {n: storage.from_array(np.zeros(shape), backend="cuda", default_origin=(climate.HALO, climate.HALO, 0),
                               device="cpu") for n in climate.FIELD_NAMES}
    return climate.build_program("cuda", dom, name=name).compiled(f, dict(climate.DEFAULT_SCALARS)).group_objects[0]


ODD_ORIGINS = {"phi": (1, 3, 1), "u": (2, 1, 0), "v": (3, 2, 2), "adv": (1, 1, 1), "phi_star": (2, 3, 0),
               "out": (1, 2, 1), "a": (1, 1, 1), "m": (2, 1, 0), "o1": (3, 2, 0), "o2": (1, 3, 2)}


def _mixed_defs(a: Field[np.float64], m: Field[np.bool_], o1: Field[np.float64], o2: Field[np.float64]):
    # a streams through the PARALLEL loop's ring, and the FORWARD loop stages
    # it too, beside a bool field that rules out its double buffer
    with computation(PARALLEL), interval(...):
        o1 = a[1, 0, 0] + a[0, 0, 0]
    with computation(FORWARD):
        with interval(0, 1):
            o2 = a[1, 0, 0] if m[0, 1, 0] else a[0, 0, 0]
        with interval(1, None):
            o2 = (a[1, 0, 0] if m[0, 1, 0] else a[0, 0, 0]) + o2[0, 0, -1]


@pytest.mark.parametrize("which", ["group0", "advect", "euler", "diffuse", "mixed"])
@pytest.mark.parametrize("origins", ["halo", "odd"])
def test_pipelined_kernel_equals_the_plain_load_kernel(card, which, origins):
    """On a ragged 37 x 29 x 7 domain (tiles cut in I and J), with the
    fields at the halo or at odd, unequal origins (16-byte rows shifted)."""
    from repro_torch.core import gtscript
    from repro_torch.stencils import climate

    if which == "mixed":
        obj = gtscript.stencil("cuda", disable_passes=("interval_splitting",))(_mixed_defs)
    else:
        obj = _climate_group("pipe_g0") if which == "group0" else climate.build_stencils("cuda")[which]
    kernels = _kernels(obj)
    dom = (37, 29, 7)
    orig = {n: (climate.HALO, climate.HALO, 0) if origins == "halo" else ODD_ORIGINS[n]
            for n, *_ in kernels[0].module.FIELDS}
    fields = _card_fields(kernels[0], dom, orig, seed=11)
    _same_bits(kernels, fields, dict(climate.DEFAULT_SCALARS), dom, orig)


def test_pipelined_member_batched_group_equals_the_plain_load_kernel(card):
    """Three members, the winds shared by all (member stride 0)."""
    from repro_torch.stencils import climate

    kernels = _kernels(_climate_group("pipe_g0_members"), members=3)
    dom = (37, 29, 7)
    orig = {n: ODD_ORIGINS[n] for n, *_ in kernels[0].module.FIELDS}
    fields = _card_fields(kernels[0], dom, orig, members=3, shared=("u", "v"), seed=12)
    _same_bits(kernels, fields, dict(climate.DEFAULT_SCALARS), dom, orig, members=3)


def test_pipelined_distributed_group_on_padded_buffers_equals_the_plain_load_kernel(card, tmp_path):
    """The distributed program's group 0 (``<name>_dist_g0``) on padded rank
    buffers of the rank step's depth, the names bound to their interiors."""
    import torch.distributed as dist

    from repro_torch.core import storage
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel import halo
    from repro_torch.stencils import climate

    dom = (37, 29, 7)
    rng = np.random.default_rng(13)
    local = {}
    for n in climate.FIELD_NAMES:
        t = storage.card_tensor(dom, torch.float64, card)
        local[n] = t.copy_(torch.from_numpy(rng.normal(size=dom)))
    prog = climate.build_program("cuda", dom, name="pipe_dist_step")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0, world_size=1)
    try:
        dp = prog.distribute(make_mesh((1, 1), ("data", "model")), periodic=(True, True))
        plan = dp.plan(local, dict(climate.DEFAULT_SCALARS))
    finally:
        dist.destroy_process_group()
    obj = plan.group_objects[0]
    assert obj.name.endswith("_dist_g0") and plan.depth >= 1
    kernels = _kernels(obj)
    fields, orig = {}, {}
    for n, *_ in kernels[0].module.FIELDS:
        padded = halo.padded_like(local.get(n, local["phi"]), plan.depth, card=True)
        fields[n] = padded.copy_(torch.randn(padded.shape, dtype=torch.float64, device=card))
        orig[n] = (plan.depth, plan.depth, 0)
    _same_bits(kernels, fields, dict(climate.DEFAULT_SCALARS), plan.local_domain, orig)


def test_program_counts_group0s_ring_bytes_and_none_for_group1(card):
    """``prefetch_counts()`` after two steps of the climate program: group
    0's rings twice over, group 1 (a walk) nothing."""
    from repro_torch.core import codegen_cuda, storage
    from repro_torch.stencils import climate

    dom = (37, 29, 7)
    shape = (dom[0] + 2 * climate.HALO, dom[1] + 2 * climate.HALO, dom[2])
    rng = np.random.default_rng(14)
    f = {n: storage.from_array(rng.normal(size=shape), backend="cuda", default_origin=(climate.HALO, climate.HALO, 0),
                               device="cuda") for n in climate.FIELD_NAMES}
    prog = climate.build_program("cuda", dom, name="pipe_counted_step")
    prog(**f, **climate.DEFAULT_SCALARS)
    torch.cuda.synchronize()
    g0, g1 = (obj.kernel for obj in next(iter(prog._cache.values())).group_objects)
    codegen_cuda.reset_launch_counts()
    for _ in range(2):
        prog(**f, **climate.DEFAULT_SCALARS)
    torch.cuda.synchronize()
    counts = codegen_cuda.prefetch_counts()
    assert counts[g0.key] == 2 * g0.prefetch_bytes(dom) > 0
    assert counts.get(g1.key, 0) == 0
