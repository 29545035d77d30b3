"""The port's kernel entry points and its CUDA code generator, on the CPU.

``ops.hdiff``/``ops.vadv`` on CPU tensors run the plain torch module of the
generated stencil; they are held against the reference's Pallas kernels, run
as ``tests/test_kernels.py`` runs them (interpret mode, small blocks).  The
generated CUDA source cannot compile here, so it is checked as text and
through its schedule metadata; ``test_torch_gpu.py`` launches it on a card.
"""

import pytest

pytest.importorskip("torch", reason="the torch port's tests need PyTorch")

import re

import jax.numpy as jnp
import numpy as np
import torch

import corpus_gen
from repro.core.stencil import build_from_definition as r_build
from repro.kernels.hdiff.ops import hdiff as r_hdiff_op
from repro.kernels.hdiff.ref import hdiff_ref as r_hdiff_ref
from repro.kernels.vadv.ops import vadv as r_vadv_op
from repro.kernels.vadv.ref import vadv_ref as r_vadv_ref
from repro_torch.core import codegen_cuda, gtscript, ir_json
from repro_torch.core.gtscript import IJK, K, PARALLEL, Field, GTScriptSemanticError, computation, interval
from repro_torch.core.stencil import build_from_definition as t_build
from repro_torch.kernels.hdiff.ops import hdiff
from repro_torch.kernels.hdiff.ref import hdiff_ref
from repro_torch.kernels.vadv.ops import vadv
from repro_torch.kernels.vadv.ref import vadv_ref
from repro_torch.stencils import forecast, hdiff as t_hdiff, vadv as t_vadv, vintg as t_vintg


def _tridiagonal(shape, seed, off=0.1, diag=2.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) * off, diag + rng.random(shape), rng.normal(size=shape) * off,
            rng.normal(size=shape))


@pytest.mark.parametrize("shape", [(12, 12, 4), (17, 23, 7)])
def test_hdiff_op_matches_reference_kernel(shape):
    ni, nj, nk = shape
    x = np.random.default_rng(11).normal(size=(ni + 6, nj + 6, nk))
    ref = np.asarray(r_hdiff_op(jnp.asarray(x), 0.05, block=(4, 8)))
    got = hdiff(torch.from_numpy(x), 0.05)
    assert got.shape == x.shape and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-12)
    np.testing.assert_allclose(hdiff_ref(torch.from_numpy(x), 0.05).numpy(),
                               np.asarray(r_hdiff_ref(jnp.asarray(x), 0.05)), atol=1e-12)


@pytest.mark.parametrize("shape", [(6, 6, 8), (5, 9, 17)])
def test_vadv_op_matches_reference_kernel(shape):
    a, b, c, d = _tridiagonal(shape, 0)
    ref = np.asarray(r_vadv_op(*(jnp.asarray(v) for v in (a, b, c, d)), block=(4, 4)))
    got = vadv(*(torch.from_numpy(v) for v in (a, b, c, d)))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-10)
    np.testing.assert_allclose(vadv_ref(*(torch.from_numpy(v) for v in (a, b, c, d))).numpy(),
                               np.asarray(r_vadv_ref(*(jnp.asarray(v) for v in (a, b, c, d)))), atol=1e-10)


@pytest.mark.parametrize("nk", [2, 3, 7, 12])
def test_vadv_op_solves_the_system(nk):
    a, b, c, d = _tridiagonal((3, 4, nk), nk, off=0.2, diag=3.0)
    x = vadv(*(torch.from_numpy(v) for v in (a, b, c, d))).numpy()
    resid = b * x - d
    resid[..., 1:] += a[..., 1:] * x[..., :-1]
    resid[..., :-1] += c[..., :-1] * x[..., 1:]
    assert np.max(np.abs(resid)) < 1e-8


# ---------------------------------------------------------------------------
# the generated CUDA source
# ---------------------------------------------------------------------------

SOURCES = {
    "hdiff": lambda: t_hdiff.build_hdiff("cuda"),
    "hdiff_smag": lambda: t_hdiff.build_hdiff_smag("cuda"),
    "vadv": lambda: t_vadv.build_vadv("cuda"),
    "vadv_system": lambda: t_vadv.build_vadv_system("cuda"),
    "vadv_boundary": lambda: t_vadv.build_vadv_boundary("cuda"),
    "vintg": lambda: t_vintg.build_vintg("cuda"),
    "advect": lambda: gtscript.stencil("cuda")(forecast.advect_defs),
}


@pytest.mark.parametrize("name", sorted(SOURCES))
def test_one_kernel_per_stencil_with_a_c_entry(name):
    st = SOURCES[name]()
    src = st.generated_source
    assert src.count("__global__") == 1
    assert st.kernel.module.KERNEL in src and 'extern "C" int launch_' in src
    assert "return (int)cudaGetLastError();" in src
    assert "repro/core/codegen_pallas.py" in src  # says which TPU kernel it replaces
    bi, bj = st.kernel.module.BLOCK
    assert st.kernel.module._smem_bytes(bi, bj) == st.kernel.module.SMEM_BYTES
    assert st.kernel.module._smem_bytes(2 * bi, bj) >= st.kernel.module.SMEM_BYTES
    assert st.kernel.module.SMEM_BYTES <= codegen_cuda.SMEM_DEFAULT_LIMIT


def test_windowed_and_full_carries_have_their_storage():
    sched = t_vintg.build_vintg("cuda").kernel.module.SCHEDULE
    assert set(sched["temporaries"].values()) == {"window"}
    sched = t_vadv.build_vadv("cuda").kernel.module.SCHEDULE
    assert sched["temporaries"]["cp"] == sched["temporaries"]["dp"] == "full"
    sched = t_hdiff.build_hdiff("cuda").kernel.module.SCHEDULE
    assert sched["staged_inputs"] == ["in_phi[k+0]"]


def _schedule_cases():
    cases = [(n, None) for n in ("hdiff", "vadv", "vintg", "vadv_boundary", "vadv_system")]
    cases += [(p.stem, p) for p in sorted(corpus_gen.CORPUS_DIR.glob("prog_*.json"))
              if corpus_gen.pallas_compatible(corpus_gen.load_program(p))]
    return cases


@pytest.mark.parametrize("name,path", _schedule_cases(), ids=[c[0] for c in _schedule_cases()])
def test_schedule_matches_reference_pallas_module(name, path):
    if path is None:
        from repro.stencils import hdiff as rh, vadv as rv, vintg as ri

        ref = {"hdiff": lambda: rh.build_hdiff("pallas"), "vadv": lambda: rv.build_vadv("pallas"),
               "vintg": lambda: ri.build_vintg("pallas"), "vadv_boundary": lambda: rv.build_vadv_boundary("pallas"),
               "vadv_system": lambda: rv.build_vadv_system("pallas")}[name]()
        st = SOURCES[name]()
    else:
        ref = r_build(corpus_gen.load_program(path), "pallas")
        st = t_build(ir_json.load_program(path), "cuda")
    for key in ("halo", "dma_inputs", "dma_first_use_ms", "sweeps", "full_carry_fields",
                "window_fields", "window_planes"):
        assert st.kernel.module.SCHEDULE[key] == ref._module.SCHEDULE[key], key


def test_written_api_field_read_at_offset_is_rejected():
    path = corpus_gen.CORPUS_DIR / "prog_07.json"  # the api-feedback template
    assert not corpus_gen.pallas_compatible(corpus_gen.load_program(path))
    with pytest.raises(GTScriptSemanticError, match="horizontal offset"):
        t_build(ir_json.load_program(path), "cuda")
    t_build(ir_json.load_program(path), "torch")  # the plain backends take it


_REJECTED = [p for p in sorted(corpus_gen.CORPUS_DIR.glob("prog_*.json"))
             if not corpus_gen.pallas_compatible(corpus_gen.load_program(p))]


@pytest.mark.parametrize("path", _REJECTED, ids=[p.stem for p in _REJECTED])
def test_cuda_rejects_the_corpus_programs_pallas_rejects(path):
    """The schedule test builds every Pallas-compatible program for cuda; the
    rest are rejected by the same limit, and the port's copy of the criterion
    agrees with the reference's."""
    assert not ir_json.pallas_compatible(ir_json.load_program(path))
    with pytest.raises(GTScriptSemanticError, match="horizontal offset"):
        t_build(ir_json.load_program(path), "cuda", backend_opts={"opt_level": 3})


def test_pallas_compatible_copy_agrees_with_the_reference():
    for p in sorted(corpus_gen.CORPUS_DIR.glob("prog_*.json")):
        assert ir_json.pallas_compatible(ir_json.load_program(p)) == \
            corpus_gen.pallas_compatible(corpus_gen.load_program(p)), p.stem


def test_module_launch_counts_are_read_from_the_live_kernels():
    st = t_vintg.build_vintg("cuda")
    key = st.kernel.key
    before = codegen_cuda.launch_counts().get(key, 0)
    st.launches = 3  # what three launches on a card would leave
    assert codegen_cuda.launch_counts()[key] == before + 3
    codegen_cuda.reset_launch_counts()
    assert st.launches == 0 and codegen_cuda.launch_counts()[key] == 0


def k_out_defs(a: Field[np.float64], out: Field[np.float64, K]):
    with computation(PARALLEL), interval(...):
        out = a[0, 0, 0]


def temp_vertical_defs(a: Field[np.float64], out: Field[np.float64, IJK]):
    with computation(PARALLEL), interval(0, -1):
        t = a[0, 0, 0] * 2.0
        out = t[0, 0, 1]


def test_k_axis_output_raises_not_implemented():
    with pytest.raises(NotImplementedError, match="K-field output"):
        gtscript.stencil("cuda")(k_out_defs)


def test_vertical_read_of_a_field_written_in_the_same_parallel_interval_is_rejected():
    with pytest.raises(GTScriptSemanticError, match="plane-by-plane"):
        gtscript.stencil("cuda", opt_level=0)(temp_vertical_defs)


_FLOAT_LITERAL = re.compile(r"(?<![\w.])(\d+\.\d*|\d*\.\d+|\d+[eE][-+]?\d+)([eE][-+]?\d+)?(?![\w.])")


@pytest.mark.parametrize("name", ["hdiff", "hdiff_smag", "vadv", "vadv_system", "vintg"])
def test_float32_source_has_no_bare_double_literal(name):
    build_fns = {"hdiff": t_hdiff.build_hdiff, "hdiff_smag": t_hdiff.build_hdiff_smag, "vadv": t_vadv.build_vadv,
                "vadv_system": t_vadv.build_vadv_system, "vintg": t_vintg.build_vintg}
    src = build_fns[name]("cuda", dtype="float32").generated_source
    assert "typedef float real_t;" in src and "double" not in src
    code = "\n".join(ln.split("//")[0] for ln in src.splitlines())
    bare = _FLOAT_LITERAL.findall(re.sub(r"real_t\([^()]*\)", "real_t(_)", code))
    assert bare == []
    if name not in ("vadv", "vintg"):  # those two have no float literal
        assert re.search(r"real_t\(\d+\.\d*(e-?\d+)?\)", code)  # the literals are there, typed
