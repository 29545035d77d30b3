"""The load pipeline of the ``cuda`` backend's PARALLEL loops.

A PARALLEL interval that no k-walk holds streams every read-only IJK input
it reads through a ring of shared-memory slots (``codegen_cuda`` module
docstring).  These tests hold what the generated module says and contains:
which loops stream and what (``SCHEDULE["prefetch"]``), that the ring is in
the shared-memory estimate, that group 0's plane stages read no device
memory, which temporaries are computed in registers, and the bytes a launch
brings through the rings (``prefetch_counts``).  The source is generated
here; ``tests/test_torch_dsl_gpu.py`` runs the pipelined kernels against
the plain-load ones on the card, bit for bit.
"""

import pytest

pytest.importorskip("torch", reason="the torch port's tests need PyTorch")

import numpy as np

from repro_torch.core import codegen_cuda, gtscript, storage
from repro_torch.core.gtscript import FORWARD, PARALLEL, Field, computation, interval
from repro_torch.stencils import climate, vadv, vintg

H = climate.HALO
DOM = (16, 16, 8)
SCALARS = {"dt": 0.1, "dx": 1.0, "dy": 1.0, "dz": 0.7, "alpha": 0.05}
TILE = (0, 0, 0, 0)
HALO1 = (-1, 1, -1, 1)


@pytest.fixture(scope="module")
def groups():
    """The climate program's two group stencils, compiled on CPU storages."""
    shape = (DOM[0] + 2 * H, DOM[1] + 2 * H, DOM[2])
    fields = {n: storage.from_array(np.zeros(shape), backend="cuda", default_origin=(H, H, 0), device="cpu")
              for n in climate.FIELD_NAMES}
    return climate.build_program("cuda", DOM, name="t_pipeline").compiled(fields, SCALARS).group_objects


@pytest.fixture(scope="module")
def eager():
    return climate.build_stencils("cuda")


def _prefetch(obj):
    return obj.kernel.module.SCHEDULE["prefetch"]


def _inputs(entry):
    return {(n, dk): ext for n, dk, ext in entry["inputs"]}


def test_group0_streams_phi_with_its_halo_and_both_winds(groups):
    (entry,) = _prefetch(groups[0])
    assert entry["ms"] == 0 and entry["interval"] == "[0, nk)" and entry["depth"] >= 3
    assert entry["width"] == 16
    assert _inputs(entry) == {("phi", 0): HALO1, ("u", 0): TILE, ("v", 0): TILE}


@pytest.mark.parametrize("name,inputs", [
    ("advect", {("phi", 0): HALO1, ("u", 0): TILE, ("v", 0): TILE}),
    ("euler", {("phi", 0): TILE, ("adv", 0): TILE}),
    ("diffuse", {("phi", 0): HALO1}),
])
def test_eager_kernels_stream_every_input(eager, name, inputs):
    (entry,) = _prefetch(eager[name])
    assert entry["depth"] >= 3 and _inputs(entry) == inputs
    assert eager[name].kernel.module.SCHEDULE["async_staging"]


def _forward_defs(a: Field[np.float64], o: Field[np.float64]):
    with computation(FORWARD):
        with interval(0, 1):
            o = a
        with interval(1, None):
            o = a + o[0, 0, -1]


@pytest.mark.parametrize("which", ["group1", "vadv_system", "vadv", "vintg", "forward"])
def test_walks_and_sequential_loops_have_no_pipeline(groups, eager, which):
    """Walks (group 1, ``vadv_system``), FORWARD/BACKWARD loops and
    single-level PARALLEL boundaries (``vadv``, ``vintg``) keep their loads."""
    obj = {"group1": lambda: groups[1], "vadv_system": lambda: eager["vadv_system"],
           "vadv": lambda: vadv.build_vadv("cuda"), "vintg": lambda: vintg.build_vintg("cuda"),
           "forward": lambda: gtscript.stencil("cuda")(_forward_defs)}[which]()
    assert _prefetch(obj) == []
    assert "gt_cp_async_commit" not in obj.kernel.module.CUDA_SOURCE


@pytest.mark.parametrize("block", [(8, 32), (4, 32), (2, 64), (8, 7), (4, 4)])
def test_smem_estimate_counts_the_ring(groups, block):
    """``_smem_bytes`` sizes every block from the default module's terms,
    the ring's slots (rows widened to 16-byte chunks) among them."""
    impl = groups[0].implementation_ir
    text = codegen_cuda.generate_cuda_module_source(impl, block)
    ns = {}
    exec(text, ns)
    assert ns["_smem_bytes"](*block) == ns["SMEM_BYTES"]
    default = groups[0].kernel.module
    assert default._smem_bytes(*block) == ns["SMEM_BYTES"]
    depth = _prefetch(groups[0])[0]["depth"]
    # phi: (bi + 2) rows of bj + 4 (its halo and a chunk's room), one slot a ring level
    assert (2, 4, depth, 8) in default._SMEM_TERMS and (0, 2, depth, 8) in default._SMEM_TERMS
    bi, bj = default.BLOCK
    assert default.SMEM_BYTES == depth * ((bi + 2) * (bj + 4) + 2 * bi * (bj + 2)) * 8


def test_group0_plane_stages_read_no_device_memory(groups):
    """Every read of ``u``, ``v`` and ``phi`` is a copy into the ring; the
    plane's stages read the ring, and group 0's temporaries that only feed
    the last stage are computed there in registers, behind one barrier."""
    src = groups[0].kernel.module.CUDA_SOURCE
    body = src[src.index("__global__"):src.index('extern "C"')]
    for ln in body.splitlines():
        if any(f"A_{n}(" in ln or f"f_{n} + go_{n}" in ln for n in ("phi", "u", "v")):
            assert "gt_cp_async" in ln, ln
    temps = groups[0].kernel.module.SCHEDULE["temporaries"]
    assert {n: temps[n] for n in ("_cse0", "_cse1", "_p0_fx")} == dict.fromkeys(("_cse0", "_cse1", "_p0_fx"), "inline")
    assert temps["adv"] == "reg" and "sp__cse0" not in body
    loop = body[body.index("for (int k = k0; k < k1; ++k) {"):]
    assert loop[:loop.index("stg = stg ==")].count("__syncthreads();") == 1
    assert "gt_cp_async_wait<" in loop and "A_phi_star(0, 0, 0) = " in loop


def test_plain_load_kernel_keeps_the_stored_temporaries(groups):
    """``async_staging=False``, the kernel the pipeline is timed against:
    only ``phi`` staged, with plain loads; the plane temporaries stored."""
    ns = {}
    exec(codegen_cuda.generate_cuda_module_source(groups[0].implementation_ir, async_staging=False), ns)
    sched = ns["SCHEDULE"]
    assert sched["prefetch"] == [] and not sched["async_staging"]
    assert sched["staged_inputs"] == ["phi[k+0]"]
    assert {sched["temporaries"][n] for n in ("_cse0", "_cse1", "_p0_fx")} == {"plane"}
    assert "gt_cp_async" not in ns["CUDA_SOURCE"].split("__global__")[1]


def _quotient_defs(a: Field[np.float64], b: Field[np.float64], o: Field[np.float64]):
    with computation(PARALLEL), interval(...):
        t = a[0, 0, 0] / b[0, 0, 0]
        o = t[1, 0, 0] + t[0, 0, 0] * 2.0


def _product_defs(a: Field[np.float64], b: Field[np.float64], o: Field[np.float64]):
    with computation(PARALLEL), interval(...):
        t = a[0, 0, 0] * b[0, 0, 0]
        o = t[1, 0, 0] + t[0, 0, 0] * 2.0


@pytest.mark.parametrize("defs,kind", [(_quotient_defs, "inline"), (_product_defs, "plane")])
def test_a_product_temporary_stays_stored(defs, kind):
    """A temporary read at an offset is computed in registers at each read,
    unless its value is a product, which the reader's sum could fuse into
    one fma and so round differently from the stored value."""
    st = gtscript.stencil("cuda", opt_level=0)(defs)
    assert st.kernel.module.SCHEDULE["temporaries"]["t"] == kind
    assert _inputs(_prefetch(st)[0]) == {("a", 0): (0, 1, 0, 0), ("b", 0): (0, 1, 0, 0)}


def test_prefetch_counts_the_ring_bytes_of_each_launch(groups):
    """``prefetch_counts()`` adds each launch's ring bytes by kernel key and
    is cleared with the launch counts; a kernel without a ring adds 0."""
    g0, g1 = (obj.kernel for obj in groups)
    dom = (37, 29, 7)
    # phi with its halo over 5 x 1 blocks of (8, 32), u and v on the tile, every level
    per_level = ((37 + 5 * 2) * (29 + 1 * 2) + 2 * 37 * 29) * 8
    assert g0.prefetch_bytes(dom) == 7 * per_level
    assert g0.prefetch_bytes(dom, members=3) == 3 * 7 * per_level
    assert g1.prefetch_bytes(dom) == 0

    class StandIn(codegen_cuda.CountedKernel):
        key = "k_stand_in_prefetch"

    k = StandIn()
    codegen_cuda.register_kernel(k)
    codegen_cuda.reset_launch_counts()
    k.count_launch(0, g0.prefetch_bytes(dom))
    k.count_launch(0, g0.prefetch_bytes(dom))
    assert codegen_cuda.prefetch_counts()["k_stand_in_prefetch"] == 14 * per_level
    codegen_cuda.reset_launch_counts()
    assert codegen_cuda.prefetch_counts()["k_stand_in_prefetch"] == 0 and k.launches == 0


@pytest.mark.parametrize("members,streams", [(4, True), (21, False)])
def test_rings_that_do_not_fit_keep_their_loads(members, streams):
    """The ensemble statistics read every member: at 4 members the rings fit
    in the shared memory a default block asks for (an SM's share for 768
    resident threads), at 21 (137 KB a block) they do not, and the kernel
    keeps its plain loads."""
    from repro_torch.ensemble.stats import build_ensemble_stats

    module = build_ensemble_stats(members, "cuda").kernel.module
    assert bool(module.SCHEDULE["prefetch"]) is streams
    budget = codegen_cuda._SMEM_SM // (codegen_cuda.PIPE_THREADS // 256) - codegen_cuda._SMEM_BLOCK_RESERVED
    assert (module.SMEM_BYTES <= budget) if streams else module.SMEM_BYTES == 0


@pytest.mark.parametrize("block,launch", [((8, 32), 76800), ((4, 32), 37888), ((8, 64), 115712)])
def test_a_pipelined_kernel_leaves_room_for_768_threads_and_no_more(groups, block, launch):
    """Its launch asks for an SM's shared memory over the blocks that make
    768 resident threads (1 KB a block reserved), its own need where larger;
    group 1, which has no pipeline, asks for its own."""
    ns = {}
    exec(codegen_cuda.generate_cuda_module_source(groups[0].implementation_ir, block), ns)
    src = ns["CUDA_SOURCE"]
    assert f"#define SMEM_LAUNCH {max(launch, ns['SMEM_BYTES'])}" in src
    assert "<<<grid, block, SMEM_LAUNCH, (cudaStream_t)stream>>>" in src
    assert "SMEM_LAUNCH" not in groups[1].kernel.module.CUDA_SOURCE
