"""The port's ``@program`` layer (``repro_torch.program``) on the CPU.

The same NumPy inputs go through the reference's programs and the port's:
on ``numpy``/``debug`` the two are bit-identical over 10 steps; the port's
``torch`` backend (and ``cuda`` on CPU tensors, which runs the groups' plain
modules) equals its own eager chain bit for bit; the ``cuda`` program splits
into the same groups and eliminates the same temporaries as the reference's
``pallas`` program, and matches it within 1e-12.  The card runs the groups'
kernels in ``test_torch_gpu.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch", reason="the torch port's tests need PyTorch")

from repro.core import gtscript as r_gtscript  # noqa: E402
from repro.core import storage as r_storage  # noqa: E402
from repro.program import program as r_program  # noqa: E402
from repro.stencils import forecast as r_forecast  # noqa: E402
from repro.stencils import vadv as r_vadv  # noqa: E402
from repro_torch.core import gtscript, storage  # noqa: E402
from repro_torch.core.gtscript import PARALLEL, Field, computation, interval  # noqa: E402
from repro_torch.program import (  # noqa: E402
    ProgramError,
    ProgramTraceError,
    program,
    request_exchange,
)
from repro_torch.program.graph import ProgramGraph  # noqa: E402
from repro_torch.program.passes import eliminate_dead_stores  # noqa: E402
from repro_torch.stencils import climate, forecast  # noqa: E402

H = climate.HALO
DOM = (16, 16, 8)
SHAPE = (DOM[0] + 2 * H, DOM[1] + 2 * H, DOM[2])
NT = 10
SCALARS = {"dt": 0.1, "dx": 1.0, "dy": 1.0, "dz": 0.7, "alpha": 0.05}
FIELD_NAMES = climate.FIELD_NAMES
REPORT_KEYS = ("groups", "group_stencils", "eliminated_temporaries", "rotation")


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    xx, yy = np.meshgrid(np.linspace(-2, 2, SHAPE[0]), np.linspace(-2, 2, SHAPE[1]), indexing="ij")
    out = {n: np.zeros(SHAPE) for n in FIELD_NAMES}
    out["phi"] = np.exp(-(xx**2 + yy**2))[:, :, None] * np.ones((1, 1, DOM[2])) + 1e-2 * rng.normal(size=SHAPE)
    out["u"] = np.full(SHAPE, 0.8)
    out["v"] = np.full(SHAPE, -0.4)
    out["w"] = 0.2 * rng.random(SHAPE)
    return out


def _port_fields(backend, arrays=None):
    arrays = _arrays() if arrays is None else arrays
    kw = {} if backend in ("numpy", "debug") else {"device": "cpu"}
    return {n: storage.from_array(a, backend=backend, default_origin=(H, H, 0), **kw) for n, a in arrays.items()}


def _ref_fields(backend):
    return {n: r_storage.from_array(a, backend=backend, default_origin=(H, H, 0)) for n, a in _arrays().items()}


def _ref_climate_program(backend, name):
    build = r_gtscript.stencil(backend=backend)
    advect, euler, diffuse = (build(d) for d in (r_forecast.advect_defs, r_forecast.euler_defs,
                                                 r_forecast.diffuse_defs))
    wsys, vsolve = build(r_vadv.vadv_system_defs), build(r_vadv.vadv_defs)

    @r_program(backend=backend, name=name)
    def climate_step(phi, u, v, w, adv, phi_star, phi_h, a, b, c, d, phi_new, *, dt, dx, dy, dz, alpha):
        advect(phi, u, v, adv, dx=dx, dy=dy, domain=DOM)
        euler(phi, adv, phi_star, dt=dt, domain=DOM)
        diffuse(phi_star, phi_h, alpha=alpha, domain=DOM)
        wsys(w, phi_h, a, b, c, d, dt=dt, dz=dz, domain=DOM)
        vsolve(a, b, c, d, phi_new, domain=DOM)
        return {"phi": phi_new, "phi_new": phi}

    return climate_step


def _np(v):
    return v.to_numpy() if hasattr(v, "to_numpy") else np.asarray(v)


# ---------------------------------------------------------------------------
# outputs: the reference's programs, and the port's own eager chain
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["numpy", "debug"])
def test_program_bit_identical_to_reference_program_10_steps(backend):
    ref_prog = _ref_climate_program(backend, f"r_climate_{backend}")
    port_prog = climate.build_program(backend, DOM, name=f"t_climate_{backend}")
    rf, pf = _ref_fields(backend), _port_fields(backend)
    sc = {k: np.float64(v) for k, v in SCALARS.items()}
    for _ in range(NT):
        ref_prog(**rf, **sc)
        port_prog(**pf, **sc)
    for n in ("phi", "phi_new", "phi_star", "phi_h"):
        np.testing.assert_array_equal(_np(pf[n]), _np(rf[n]), err_msg=n)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_fused_program_bit_identical_to_eager_chain_10_steps(backend):
    st = climate.build_stencils(backend)
    prog = climate.build_program(backend, DOM, stencils=st, name=f"t_fused_{backend}")
    pf, ef = _port_fields(backend), _port_fields(backend)
    for _ in range(NT):
        prog(**pf, **SCALARS)
        climate.eager_step(st, ef, DOM, SCALARS)
    for n in ("phi", "phi_new", "phi_star", "phi_h"):
        assert torch.equal(pf[n].data, ef[n].data), n


def test_torch_program_matches_numpy_reference_program():
    ref_prog = _ref_climate_program("numpy", "r_climate_np_vs_torch")
    prog = climate.build_program("torch", DOM, name="t_climate_torch_vs_np")
    rf, pf = _ref_fields("numpy"), _port_fields("torch")
    for _ in range(NT):
        ref_prog(**rf, **{k: np.float64(v) for k, v in SCALARS.items()})
        prog(**pf, **SCALARS)
    np.testing.assert_allclose(_np(pf["phi"]), _np(rf["phi"]), rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------------------
# structure: the cuda program against the reference's pallas program
# ---------------------------------------------------------------------------


def test_cuda_climate_program_structure_and_values_match_reference_pallas():
    ref_prog = _ref_climate_program("pallas", "r_climate_pallas")
    prog = climate.build_program("cuda", DOM, name="t_climate_cuda")
    rf, pf = _ref_fields("pallas"), _port_fields("cuda")
    r_info, p_info = {}, {}
    for t in range(2):
        ref_prog(**rf, **SCALARS, exec_info=r_info if t == 0 else None)
        prog(**pf, **SCALARS, exec_info=p_info if t == 0 else None)
    r_rep, p_rep = r_info["program_report"], p_info["program_report"]
    assert {k: p_rep[k] for k in REPORT_KEYS} == {k: r_rep[k] for k in REPORT_KEYS}
    assert p_rep["group_stencils"] == [["advect_defs", "euler_defs"],
                                       ["diffuse_defs", "vadv_system_defs", "vadv_defs"]]
    assert set(p_rep["eliminated_temporaries"]) == {"adv", "a", "b", "c", "d"}
    assert [t["group"] for t in p_rep["node_timings"]] == [0, 1]
    assert all(t["clock"] == "host" for t in p_rep["node_timings"])  # CPU tensors: no CUDA events
    np.testing.assert_allclose(_np(pf["phi"]), _np(rf["phi"]), rtol=1e-12, atol=1e-12)


def test_cuda_forecast_program_structure_matches_reference_pallas():
    dom = (12, 10, 5)
    ref_step = r_forecast.build_forecast_step("pallas", dom, name="r_fc_pallas")
    step = forecast.build_forecast_step("cuda", dom, name="t_fc_cuda")
    rf, rsc = r_forecast.make_forecast_fields("pallas", dom, seed=3)
    pf, psc = forecast.make_forecast_fields("cuda", dom, seed=3, device="cpu")
    assert psc == rsc
    for n in forecast.FIELD_NAMES:
        np.testing.assert_array_equal(pf[n].to_numpy(), np.asarray(rf[n].data))
    r_rep = ref_step.compiled(rf, rsc).report
    p_rep = step.compiled(pf, psc).report
    assert {k: p_rep[k] for k in REPORT_KEYS} == {k: r_rep[k] for k in REPORT_KEYS}
    assert p_rep["groups"] == 2
    np.testing.assert_array_equal(forecast.request_state(dom, seed=5), r_forecast.request_state(dom, seed=5))


def test_cuda_groups_carry_the_kernels_and_their_schedule():
    prog = climate.build_program("cuda", DOM, name="t_climate_sched")
    cp = prog.compiled(_port_fields("cuda"), SCALARS)
    assert [k.key for k in cp.group_kernels] == [o.kernel.key for o in cp.group_objects]
    temps = [o.kernel.module.SCHEDULE["temporaries"] for o in cp.group_objects]
    assert temps[0]["adv"] == "reg"  # the first group keeps adv out of device memory
    assert {temps[1][n] for n in ("a", "b", "c", "d")} == {"full"}  # the second spills them (ROADMAP)
    assert all(o.launches == 0 for o in cp.group_objects)  # CPU tensors launch nothing


# ---------------------------------------------------------------------------
# iterate, rotation, writes, caching
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_iterate_equals_n_calls(backend):
    prog = climate.build_program(backend, DOM, name=f"t_iter_{backend}")
    a, b = _port_fields(backend), _port_fields(backend)
    info = {}
    outs = prog.iterate(7, **a, **SCALARS, exec_info=info)
    for _ in range(7):
        prog(**b, **SCALARS)
    for n in FIELD_NAMES:
        assert torch.equal(a[n].data, b[n].data), n
    assert info["program_report"]["iterated_steps"] == 7
    assert outs["phi"] is a["phi"].data


def test_iterate_rejected_on_numpy_and_for_unrotated_outputs():
    with pytest.raises(ProgramError, match="iterate\\(\\) requires"):
        climate.build_program("numpy", DOM, name="t_iter_np").iterate(2, **_port_fields("numpy"), **SCALARS)
    euler = gtscript.stencil(backend="torch")(forecast.euler_defs)

    @program(backend="torch", name="t_noniter")
    def step(phi, adv, out, *, dt):
        euler(phi, adv, out, dt=dt, domain=DOM)
        return {"result": out}  # not a program field name

    f = _port_fields("torch")
    with pytest.raises(ProgramError, match="cannot iterate"):
        step.iterate(3, f["phi"], f["adv"], f["phi_new"], dt=0.1)


@pytest.mark.parametrize("backend", ["numpy", "torch", "cuda"])
def test_rotation_rebinds_storages_and_written_fields_persist(backend):
    st = climate.build_stencils(backend)
    prog = climate.build_program(backend, DOM, stencils=st, name=f"t_rot_{backend}")
    p, e = _port_fields(backend), _port_fields(backend)
    before_phi, before_new = p["phi"].data, p["phi_new"].data
    prog(**p, **SCALARS)
    assert p["phi"].data is before_new and p["phi_new"].data is before_phi  # swapped, not copied
    climate.eager_step(st, e, DOM, SCALARS)
    for n in ("phi_star", "phi_h"):  # written inside the program, not returned
        np.testing.assert_array_equal(_np(p[n]), _np(e[n]))
        assert float(np.abs(_np(p[n])).max()) > 0.0


def test_compiled_program_cached_per_geometry():
    prog = climate.build_program("cuda", DOM, name="t_cache")
    p = _port_fields("cuda")
    prog(**p, **SCALARS)
    prog(**{n: p[n] for n in reversed(FIELD_NAMES)}, **SCALARS)
    assert len(prog._cache) == 1
    cp = next(iter(prog._cache.values()))
    assert len(cp.fingerprint) == 16
    # another shape is another geometry: traced and compiled anew
    q = {n: storage.from_array(np.concatenate([a, a[:, :, :1]], axis=2), backend="cuda",
                               default_origin=(H, H, 0), device="cpu") for n, a in _arrays().items()}
    prog.compiled(q, SCALARS)
    assert len(prog._cache) == 2
    assert prog.compiled(p, SCALARS) is cp


def test_generated_orchestrator_is_inspectable():
    prog = climate.build_program("cuda", DOM, name="t_orch")
    cp = prog.compiled(_port_fields("cuda"), SCALARS)
    src = cp.generated_source
    assert "Auto-generated by repro_torch.program" in src
    assert "group_runs[0]" in src and "group_runs[1]" in src
    assert "'phi': vals['phi_new']" in src and "'phi_new': vals['phi']" in src
    assert "Auto-generated by repro_torch.core.codegen_cuda" in cp.group_objects[0].generated_source


def test_cross_group_temporary_allocated_on_the_fields_device():
    """A buffer internal to the program but touched by two groups is
    allocated by the orchestrator (zeros, on the fields' device, in the card
    layout on cuda) — the eager chain's values all the same."""
    b = gtscript.stencil(backend="cuda")
    euler, diffuse = b(forecast.euler_defs), b(forecast.diffuse_defs)

    def calls(phi, u, v, adv, phi_star, phi_new, dt, alpha):
        euler(phi, phi, adv, dt=dt, domain=DOM)  # adv: written by the first group, read by the second
        euler(phi, phi, phi_star, dt=dt, domain=DOM)
        diffuse(phi_star, v, alpha=alpha, domain=DOM)  # splits: phi_star read off-center
        euler(v, adv, phi_new, dt=dt, domain=DOM)

    @program(backend="cuda", name="t_xgroup")
    def step(phi, u, v, adv, phi_star, phi_new, *, dt, alpha):
        calls(phi, u, v, adv, phi_star, phi_new, dt, alpha)
        return {"phi": phi_new, "phi_new": phi}

    f, e = _port_fields("cuda"), _port_fields("cuda")
    names = ("phi", "u", "v", "adv", "phi_star", "phi_new")
    info = {}
    step(*(f[n] for n in names), dt=0.1, alpha=0.05, exec_info=info)
    cp = next(iter(step._cache.values()))
    assert info["program_report"]["groups"] == 2
    assert cp.alloc_internals == ["adv"] and cp.temp_internals == ["v"]
    assert "vals['adv'] = card_tensor(lead + " in cp.generated_source
    calls(*(e[n] for n in names), 0.1, 0.05)
    assert torch.equal(f["phi"].data, e["phi_new"].data)


def test_distribute_is_not_ported_yet():
    prog = climate.build_program("cuda", DOM, name="t_dist")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        prog.distribute(None)


# ---------------------------------------------------------------------------
# the tracer: recording, versions, dead stores, what must raise
# ---------------------------------------------------------------------------


def scale_defs(a: Field[np.float64], b: Field[np.float64], *, f: np.float64):
    with computation(PARALLEL), interval(...):
        b = f * a  # noqa: F841


SDOM = (8, 8, 4)
SSHAPE = (10, 10, 4)


def _sstores(*names, backend="torch"):
    rng = np.random.default_rng(0)
    return {n: storage.from_array(rng.normal(size=SSHAPE), backend=backend, default_origin=(1, 1, 0), device="cpu")
            for n in names}


def test_trace_records_nodes_and_versions():
    sc = gtscript.stencil(backend="torch")(scale_defs)

    @program(backend="torch", name="t_versions")
    def step(x, y, z, *, f):
        sc(x, y, f=f, domain=SDOM)
        sc(y, z, f=f, domain=SDOM)
        sc(z, y, f=f, domain=SDOM)
        return {"y": y, "z": z}

    t = step.trace(_sstores("x", "y", "z"), {"f": 2.0})
    assert [n.stencil.name for n in t.nodes] == ["scale_defs"] * 3
    assert t.nodes[0].write_versions == {"y": 1}
    assert t.nodes[1].read_versions["y"] == 1
    assert t.nodes[2].write_versions == {"y": 2}
    assert t.outputs == {"y": ("y", 2), "z": ("z", 1)}


def test_dead_store_dropped_and_liveness_is_version_accurate():
    sc = gtscript.stencil(backend="torch")(scale_defs)

    @program(backend="torch", name="t_dse")
    def step(x, dead, kept, *, f):
        sc(x, dead, f=f, domain=SDOM)  # never read again, not returned
        sc(x, kept, f=f, domain=SDOM)
        return kept

    s = _sstores("x", "dead", "kept")
    dead_before = s["dead"].data.clone()
    info = {}
    step(s["x"], s["dead"], s["kept"], f=3.0, exec_info=info)
    assert info["program_report"]["dead_stores_eliminated"] == ["scale_defs"]
    assert torch.equal(s["dead"].data, dead_before)  # the dead store did not run
    assert torch.equal(s["kept"].data[1:-1, 1:-1], 3.0 * s["x"].data[1:-1, 1:-1])

    @program(backend="torch", name="t_dse_versions")
    def step2(x, y, z, *, f):
        sc(x, y, f=f, domain=SDOM)
        sc(y, z, f=f, domain=SDOM)
        sc(x, y, f=f, domain=SDOM)  # y@2 unread and not returned: dead
        return z

    live, dropped = eliminate_dead_stores(ProgramGraph(step2.trace(_sstores("x", "y", "z"), {"f": 2.0})))
    assert len(live) == 2 and dropped == ["scale_defs"]


def test_what_the_tracer_refuses():
    sc = gtscript.stencil(backend="torch")(scale_defs)
    sn = gtscript.stencil(backend="numpy")(scale_defs)
    foreign = storage.zeros(SSHAPE, backend="torch", default_origin=(1, 1, 0), device="cpu")

    @program(backend="torch", name="t_fieldmath")
    def fieldmath(x, y, *, f):
        sc(x + 1.0, y, f=f, domain=SDOM)
        return y

    @program(backend="torch", name="t_scalarmath")
    def scalarmath(x, y, *, f):
        sc(x, y, f=f * 2.0, domain=SDOM)
        return y

    @program(backend="torch", name="t_foreign")
    def nontraced(x, y, *, f):
        sc(x, foreign, f=f, domain=SDOM)
        return y

    @program(backend="torch", name="t_none")
    def returns_none(x, y, *, f):
        sc(x, y, f=f, domain=SDOM)

    @program(backend="torch", name="t_mixed")
    def mixed(x, y, *, f):
        sc(x, y, f=f, domain=SDOM)
        sn(y, x, f=f, domain=SDOM)
        return x

    s = _sstores("x", "y")
    for prog, match in ((fieldmath, "cannot apply"), (scalarmath, "precompute derived scalars"),
                        (nontraced, "non-traced value"), (returns_none, "return its outputs"),
                        (mixed, "mixes stencil backends")):
        with pytest.raises(ProgramTraceError, match=match):
            prog(s["x"], s["y"], f=2.0)


def test_exchange_marker_recorded_and_elided_on_one_device():
    sc = gtscript.stencil(backend="torch")(scale_defs)

    @program(backend="torch", name="t_exch")
    def step(x, y, z, *, f):
        sc(x, y, f=f, domain=SDOM)
        request_exchange(y)  # a mesh's exchange point; no barrier on one device
        sc(y, z, f=f, domain=SDOM)
        return z

    s = _sstores("x", "y", "z")
    assert [type(n).__name__ for n in step.trace(s, {"f": 2.0}).nodes] == [
        "StencilNode", "ExchangeNode", "StencilNode"]
    info = {}
    step(s["x"], s["y"], s["z"], f=2.0, exec_info=info)
    rep = info["program_report"]
    assert rep["groups"] == 1 and rep["elided_exchanges"] == 1
    assert torch.allclose(s["z"].data[1:-1, 1:-1], 4.0 * s["x"].data[1:-1, 1:-1], rtol=1e-15, atol=0)
    arr = np.ones(4)
    assert request_exchange(arr) is arr


def test_different_domains_split_groups_and_stay_exact():
    sc = gtscript.stencil(backend="torch")(forecast.euler_defs)
    small = (DOM[0] // 2, DOM[1] // 2, DOM[2])

    @program(backend="torch", name="t_twodoms")
    def step(phi, adv, phi_star, phi_new, *, dt):
        sc(phi, adv, phi_star, dt=dt, domain=DOM)
        sc(phi_star, adv, phi_new, dt=dt, domain=small)
        return {"phi_new": phi_new, "phi_star": phi_star}

    p, s = _port_fields("torch"), _port_fields("torch")
    info = {}
    step(p["phi"], p["w"], p["phi_star"], p["phi_new"], dt=0.1, exec_info=info)
    assert info["program_report"]["groups"] == 2
    sc(s["phi"], s["w"], s["phi_star"], dt=0.1, domain=DOM)
    sc(s["phi_star"], s["w"], s["phi_new"], dt=0.1, domain=small)
    assert torch.equal(p["phi_new"].data, s["phi_new"].data)
    assert torch.equal(p["phi_star"].data, s["phi_star"].data)
