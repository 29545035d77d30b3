"""The torch port's ``torch`` and ``cuda`` backends and its storage, on the CPU.

The ``torch`` backend (the plain PyTorch version of the generated kernel) is
held against the reference ``numpy`` backend at ``rtol=1e-12`` on identical
NumPy inputs.  ``cuda`` on CPU tensors runs that plain module; on CUDA
tensors it launches its kernel, which only the card can run (``gpu`` tests).
"""

import pytest

pytest.importorskip("torch", reason="the torch port's tests need PyTorch")

import numpy as np
import torch

import corpus_gen
from repro.core.stencil import build_from_definition as r_build
from repro.stencils import forecast as r_forecast
from repro.stencils import hdiff as r_hdiff
from repro.stencils import vadv as r_vadv
from repro.stencils import vintg as r_vintg
from repro_torch.core import gtscript, ir_json, storage
from repro_torch.core.stencil import build_from_definition as t_build
from repro_torch.stencils import forecast as t_forecast
from repro_torch.stencils import hdiff as t_hdiff
from repro_torch.stencils import vadv as t_vadv
from repro_torch.stencils import vintg as t_vintg
from repro.core import gtscript as r_gtscript

CORPUS = sorted(corpus_gen.CORPUS_DIR.glob("prog_*.json"))
RTOL = 1e-12  # the bound the reference uses between its XLA and numpy backends

SCALARS = {"alpha": 0.05, "dt": 0.1, "dz": 0.7, "weight": 0.6, "decay": 0.9, "dx": 1.1, "dy": 0.9}
# (name, build of the reference stencil, build of the port stencil)
STENCILS = [
    ("hdiff", lambda be: r_hdiff.build_hdiff(be), lambda be: t_hdiff.build_hdiff(be)),
    ("hdiff_nolimit", lambda be: r_hdiff.build_hdiff(be, lim=-1e30), lambda be: t_hdiff.build_hdiff(be, lim=-1e30)),
    ("hdiff_smag", lambda be: r_hdiff.build_hdiff_smag(be), lambda be: t_hdiff.build_hdiff_smag(be)),
    ("vadv", lambda be: r_vadv.build_vadv(be), lambda be: t_vadv.build_vadv(be)),
    ("vadv_system", lambda be: r_vadv.build_vadv_system(be), lambda be: t_vadv.build_vadv_system(be)),
    ("vadv_boundary", lambda be: r_vadv.build_vadv_boundary(be), lambda be: t_vadv.build_vadv_boundary(be)),
    ("vintg", lambda be: r_vintg.build_vintg(be), lambda be: t_vintg.build_vintg(be)),
    ("advect", lambda be: r_gtscript.stencil(be)(r_forecast.advect_defs),
     lambda be: gtscript.stencil(be)(t_forecast.advect_defs)),
    ("euler", lambda be: r_gtscript.stencil(be)(r_forecast.euler_defs),
     lambda be: gtscript.stencil(be)(t_forecast.euler_defs)),
    ("diffuse", lambda be: r_gtscript.stencil(be)(r_forecast.diffuse_defs),
     lambda be: gtscript.stencil(be)(t_forecast.diffuse_defs)),
]


def _inputs(st, domain, h, seed):
    rng = np.random.default_rng(seed)
    shape = (domain[0] + 2 * h, domain[1] + 2 * h, domain[2])
    data = {n: rng.normal(size=shape) for n in st.field_info}
    if "b" in data:
        data["b"] = np.abs(data["b"]) + 2.0
    return data


def _run_numpy(st, data, scalars, domain, origin):
    fields = {n: a.copy() for n, a in data.items()}
    st(**fields, **scalars, domain=domain, origin=origin)
    return {n: fields[n] for n in st.implementation_ir.written_api_fields()}


def _run_torch(st, data, scalars, domain, origin):
    fields = {n: torch.from_numpy(a.copy()) for n, a in data.items()}
    assert st(**fields, **scalars, domain=domain, origin=origin) is None  # in place
    return {n: fields[n].numpy() for n in st.implementation_ir.written_api_fields()}


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("case", STENCILS, ids=[c[0] for c in STENCILS])
def test_stencil_matches_reference_numpy(case, backend):
    name, r_make, t_make = case
    ref_st, st = r_make("numpy"), t_make(backend)
    for domain in ((7, 9, 5), (4, 3, 3)):
        data = _inputs(ref_st, domain, 3, seed=len(name))
        scalars = {s: SCALARS[s] for s in ref_st.scalar_info}
        ref = _run_numpy(ref_st, data, scalars, domain, (3, 3, 0))
        got = _run_torch(st, data, scalars, domain, (3, 3, 0))
        assert got.keys() == ref.keys()
        for n in ref:
            np.testing.assert_allclose(got[n], ref[n], rtol=RTOL, atol=RTOL, err_msg=f"{name}/{n} {domain}")
    assert st.launches == 0  # the CPU path runs no kernel


@pytest.mark.parametrize("path", CORPUS, ids=[p.stem for p in CORPUS])
def test_corpus_torch_matches_reference_numpy(path):
    r_defn, t_defn = corpus_gen.load_program(path), ir_json.load_program(path)
    cn, h = (corpus_gen.NI, corpus_gen.NJ, corpus_gen.NK), corpus_gen.HALO
    rng = np.random.default_rng(100 + int(path.stem[-2:]))
    data = {f.name: rng.normal(size=(cn[0] + 2 * h, cn[1] + 2 * h, cn[2])) for f in r_defn.api_fields if f.is_api}
    s = float(rng.normal())
    for lvl in (0, 3):
        ref = _run_numpy(r_build(r_defn, "numpy", backend_opts={"opt_level": lvl}), data, {"s": s}, cn, (h, h, 0))
        got = _run_torch(t_build(t_defn, "torch", backend_opts={"opt_level": lvl}), data, {"s": s}, cn, (h, h, 0))
        for n in ref:
            np.testing.assert_allclose(got[n], ref[n], rtol=RTOL, atol=RTOL, err_msg=f"{n} opt_level {lvl}")


def test_float32_stencil_stays_float32():
    st = t_hdiff.build_hdiff("torch", dtype="float32")
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(10, 11, 3)).astype(np.float32))
    out = x.clone()
    st(x, out, alpha=np.float64(0.05), domain=(4, 5, 3), origin=(3, 3, 0))
    assert out.dtype == torch.float32
    ref_st = r_hdiff.build_hdiff("numpy", dtype="float32")
    ref_out = x.numpy().copy()
    ref_st(x.numpy().copy(), ref_out, alpha=np.float32(0.05), domain=(4, 5, 3), origin=(3, 3, 0))
    np.testing.assert_allclose(out.numpy(), ref_out, rtol=1e-5, atol=1e-6)


def test_apply_and_as_torch_function_are_functional():
    st = t_hdiff.build_hdiff("cuda")
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(12, 12, 4)))
    out0 = x.clone()
    res = st.apply({"in_phi": x, "out_phi": out0}, {"alpha": 0.05}, origin=(3, 3, 0))
    assert set(res) == {"out_phi"}
    assert torch.equal(out0, x)  # the caller's tensors are untouched
    fn = st.as_torch_function(domain=(6, 6, 4), origin=(3, 3, 0))
    res2 = fn({"in_phi": x, "out_phi": x.clone()}, {"alpha": 0.05})
    assert torch.equal(res["out_phi"], res2["out_phi"])
    with pytest.raises(TypeError):
        t_hdiff.build_hdiff("numpy").as_torch_function(domain=(6, 6, 4))


def test_backend_argument_checks():
    st = t_hdiff.build_hdiff("torch")
    x = np.zeros((12, 12, 4))
    with pytest.raises(TypeError, match="torch tensors"):
        st(x, x.copy(), alpha=0.05)
    with pytest.raises(TypeError, match="expects dtype"):
        st(torch.zeros(12, 12, 4, dtype=torch.float32), torch.zeros(12, 12, 4, dtype=torch.float32), alpha=0.05)
    # autotune=True builds (the tuner picks the block at the first launch on
    # the card) and stays out of the fingerprint
    tuned = gtscript.stencil("cuda", autotune=True)(t_forecast.euler_defs)
    assert tuned.tunes and tuned.fingerprint == gtscript.stencil("cuda")(t_forecast.euler_defs).fingerprint
    with pytest.raises(TypeError, match="takes no options"):
        gtscript.stencil("torch", block=(4, 4))(t_forecast.euler_defs)
    with pytest.raises(ValueError, match="unknown backend"):
        gtscript.stencil("pallas")(t_forecast.euler_defs)
    assert gtscript.stencil.__defaults__[0] == "cuda"


def test_cuda_kernel_wrapper_refuses_cpu_tensors():
    st = gtscript.stencil("cuda")(t_forecast.euler_defs)
    x = torch.zeros(6, 6, 2, dtype=torch.float64)
    with pytest.raises(TypeError, match="CUDA tensor"):
        st.kernel.launch({"phi": x, "adv": x, "out": x}, {"dt": 0.1}, (6, 6, 2),
                         {n: (0, 0, 0) for n in ("phi", "adv", "out")})
    assert st.launches == 0


def test_storage_defaults_to_the_card():
    if torch.cuda.is_available():
        assert storage.zeros((4, 4, 2)).data.is_cuda
        return
    for alloc in (storage.zeros, storage.ones, storage.empty):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            alloc((4, 4, 2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        storage.from_array(np.zeros((4, 4, 2)))
    assert storage.zeros((4, 4, 2), device="cpu").data.device.type == "cpu"


def test_storage_state_round_trip_from_reference():
    from repro.core import storage as r_storage

    ref = r_storage.from_array(np.random.default_rng(2).normal(size=(3, 8, 7, 4)), backend="numpy",
                               default_origin=(0, 2, 2, 0), axes=("N", "I", "J", "K"))
    port = storage.from_array(ref.to_numpy(), backend="torch", default_origin=ref.default_origin,
                              axes=ref.axes, device="cpu")
    assert port.default_origin == ref.default_origin and port.axes == ref.axes
    assert port.dtype == np.float64 and port.members == 3
    np.testing.assert_array_equal(port.to_numpy(), ref.to_numpy())
    m1 = port.member(1)
    assert m1.axes == ("I", "J", "K") and m1.default_origin == (2, 2, 0)
    m1[0, 0, 0] = 42.0  # a view: writes reach the batched storage
    assert port.to_numpy()[1, 0, 0, 0] == 42.0
    np.testing.assert_array_equal(np.asarray(storage.from_array(port.data, backend="numpy")), port.to_numpy())
    dom = storage.storage_for_domain((4, 5, 3), (2, 2, 0), backend="torch", members=2, device="cpu")
    assert dom.shape == (2, 8, 9, 3) and dom.default_origin == (0, 2, 2, 0)
