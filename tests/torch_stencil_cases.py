# ruff: noqa: F821, F841  (GTScript definitions: parsed DSL names and assigned outputs, never executed)
"""The stencil definitions that the port's CPU mirrors and the card both run.

Each :class:`Case` is a definition with the inputs it runs on: the domain,
the storage halo, how each field starts and the scalars.
``tests/test_torch_passes.py::test_every_card_case_matches_the_reference_oracle``
holds every backend of the port against the reference's ``debug`` oracle on
each case's inputs, and the other CPU mirrors run the cases their reference
tests name; ``chip_smoke.py`` path M and ``tests/test_torch_dsl_gpu.py`` launch
the ``cuda`` kernel of each on the card at ``block=(4, 4)``, so that tile
boundaries fall inside the small domains.

This module imports neither JAX nor the reference package.
"""

import dataclasses
from pathlib import Path
from typing import Callable, Dict, Tuple

import numpy as np

from repro_torch.core import gtscript, ir_json, storage
from repro_torch.core.gtscript import (
    BACKWARD,
    FORWARD,
    IJ,
    IJK,
    PARALLEL,
    Field,
    GTScriptSemanticError,
    K,
    computation,
    interval,
)
from repro_torch.core.stencil import build_from_definition
from repro_torch.stencils.hdiff import hdiff_defs, hdiff_smag_defs
from repro_torch.stencils.library import (
    avg_x,
    avg_y,
    fwd_avg_z,
    gradx,
    gradx_c,
    grady,
    grady_c,
    laplacian,
    smagorinsky_factor,
    upwind_flux_x,
    upwind_flux_y,
)
from repro_torch.stencils.vadv import vadv_boundary_defs, vadv_defs, vadv_system_defs
from repro_torch.stencils.vintg import vintg_defs

DOMAIN = (7, 6, 5)  # the reference's test_passes.py domain
BLOCK = (4, 4)  # the block the reference's Pallas legs run at


@dataclasses.dataclass(frozen=True)
class Case:
    """A definition and the inputs it runs on.

    ``fields`` gives each field's start: ``normal`` N(0, 1); ``zeros``;
    ``small`` 0.1 N(0, 1) (vadv's off-diagonals); ``diag`` 2 + U[0, 1) (its
    diagonal); ``positive`` 1 + 0.5 N(0, 1); ``abs`` |N(0, 1)|; ``negzero``
    -0.0 everywhere.  A field's axes are ``IJK`` unless ``axes`` names them.
    Storages hold ``halo`` points on each side in I and J."""

    name: str
    defs: Callable
    fields: Tuple[Tuple[str, str], ...]
    scalars: Tuple[Tuple[str, float], ...] = ()
    externals: Tuple[Tuple[str, float], ...] = ()
    halo: int = 0
    domain: Tuple[int, int, int] = DOMAIN
    axes: Tuple[Tuple[str, Tuple[str, ...]], ...] = ()
    seed: int = 0

    def arrays(self, domain=None, seed=None) -> Dict[str, Tuple[np.ndarray, Tuple[int, ...]]]:
        """``{name: (array, origin)}``, drawn in ``fields`` order from ``seed``."""
        ni, nj, nk = domain or self.domain
        h = self.halo
        rng = np.random.default_rng(self.seed if seed is None else seed)
        axes = dict(self.axes)
        out = {}
        for name, start in self.fields:
            ax = axes.get(name, IJK)
            full = {"I": ni + 2 * h, "J": nj + 2 * h, "K": nk}
            shape = tuple(full[a] for a in ax)
            origin = tuple({"I": h, "J": h, "K": 0}[a] for a in ax)
            out[name] = (_draw(rng, start, shape), origin)
        return out


def _draw(rng, start: str, shape) -> np.ndarray:
    if start == "normal":
        return rng.normal(size=shape)
    if start == "zeros":
        return np.zeros(shape)
    if start == "small":
        return rng.normal(size=shape) * 0.1
    if start == "diag":
        return 2.0 + rng.random(shape)
    if start == "positive":
        return rng.normal(size=shape) * 0.5 + 1.0
    if start == "abs":
        return np.abs(rng.normal(size=shape))
    if start == "negzero":
        return np.full(shape, -0.0)
    raise ValueError(f"unknown start {start!r}")


# ---------------------------------------------------------------------------
# the library operators, each in a minimal stencil (the reference's test_passes.py)
# ---------------------------------------------------------------------------


def lap_defs(phi: Field[np.float64], o: Field[np.float64]):
    with computation(PARALLEL), interval(...):
        o = laplacian(phi)


def gradx_defs(phi: Field[np.float64], o: Field[np.float64]):
    with computation(PARALLEL), interval(...):
        o = gradx(phi)


def grady_defs(phi: Field[np.float64], o: Field[np.float64]):
    with computation(PARALLEL), interval(...):
        o = grady(phi)


def gradx_c_defs(phi: Field[np.float64], o: Field[np.float64]):
    with computation(PARALLEL), interval(...):
        o = gradx_c(phi)


def grady_c_defs(phi: Field[np.float64], o: Field[np.float64]):
    with computation(PARALLEL), interval(...):
        o = grady_c(phi)


def avg_x_defs(phi: Field[np.float64], o: Field[np.float64]):
    with computation(PARALLEL), interval(...):
        o = avg_x(phi)


def avg_y_defs(phi: Field[np.float64], o: Field[np.float64]):
    with computation(PARALLEL), interval(...):
        o = avg_y(phi)


def fwd_avg_z_defs(phi: Field[np.float64], o: Field[np.float64]):
    with computation(PARALLEL):
        with interval(0, -1):
            o = fwd_avg_z(phi)
        with interval(-1, None):
            o = phi


def upwind_x_defs(phi: Field[np.float64], vel: Field[np.float64], o: Field[np.float64]):
    with computation(PARALLEL), interval(...):
        o = upwind_flux_x(phi, vel)


def upwind_y_defs(phi: Field[np.float64], vel: Field[np.float64], o: Field[np.float64]):
    with computation(PARALLEL), interval(...):
        o = upwind_flux_y(phi, vel)


def smag_defs(u: Field[np.float64], v: Field[np.float64], o: Field[np.float64]):
    with computation(PARALLEL), interval(...):
        o = smagorinsky_factor(u, v)


ONE_FIELD = (lap_defs, gradx_defs, grady_defs, gradx_c_defs, grady_c_defs, avg_x_defs, avg_y_defs,
             fwd_avg_z_defs)
TWO_FIELDS = (upwind_x_defs, upwind_y_defs, smag_defs)


# ---------------------------------------------------------------------------
# the passes at work (the reference's test_passes.py)
# ---------------------------------------------------------------------------


def overwritten_local_defs(a: Field[np.float64], o: Field[np.float64]):
    with computation(PARALLEL), interval(...):
        t = a * 2.0
        if a > 0.0:
            t = a * 3.0
        o = t + 1.0


def zero_init_temp_defs(a: Field[np.float64], o: Field[np.float64]):
    with computation(PARALLEL), interval(...):
        if a > 0.0:
            t = a * 2.0
        o = t + a


def merge_forward_defs(a: Field[np.float64], o: Field[np.float64]):
    with computation(FORWARD):
        with interval(0, 2):
            o = a * 2.0
        with interval(2, None):
            o = a * 2.0


def merge_backward_defs(a: Field[np.float64], o: Field[np.float64]):
    with computation(BACKWARD):
        with interval(-1, None):
            o = a + 1.0
        with interval(0, -1):
            o = a + 1.0


def fold_literals_defs(a: Field[np.float64], o: Field[np.float64]):
    with computation(PARALLEL), interval(...):
        o = a * (2.0 * 3.0 + min(1.0, 4.0)) - 0.0


def fold_empty_then_defs(a: Field[np.float64], o: Field[np.float64]):
    with computation(PARALLEL), interval(...):
        o = a
        if a > 0.0:
            if 1.0 > 2.0:
                o = a * 5.0
        else:
            o = -a


def fold_mod_defs(a: Field[np.float64], o: Field[np.float64]):
    with computation(PARALLEL), interval(...):
        o = a + mod(-7.0, 3.0)


def negative_zero_defs(a: Field[np.float64], o: Field[np.float64]):
    with computation(PARALLEL), interval(...):
        o = a + 0.0


def cse_neighbor_sums_defs(a: Field[np.float64], o: Field[np.float64]):
    with computation(PARALLEL), interval(...):
        o = (a[1, 0, 0] + a[0, 0, 0]) + (a[0, 0, 0] + a[-1, 0, 0])


def cse_intervening_writes_defs(a: Field[np.float64], b: Field[np.float64], o: Field[np.float64]):
    with computation(PARALLEL), interval(...):
        t1 = a * a + b
        b = t1 * 2.0
        t2 = a * a + b
        o = t1 + t2


def reassociation_defs(u: Field[np.float64], v: Field[np.float64], o: Field[np.float64]):
    with computation(PARALLEL), interval(...):
        t1 = u * v + u
        t2 = v * u + v
        o = t1 + t2


def interval_merging_vertical_defs(phi: Field[np.float64], o: Field[np.float64]):
    with computation(PARALLEL):
        with interval(0, 1):
            t = phi * 2.0
            o = t[0, 0, 1] + phi
        with interval(1, None):
            t = phi * 2.0
            o = t[0, 0, 1] + phi


# ---------------------------------------------------------------------------
# the kernel's schedule (the reference's test_pallas_schedule.py)
# ---------------------------------------------------------------------------


def window_depth_two_defs(a: Field[np.float64], o: Field[np.float64]):
    with computation(FORWARD):
        with interval(0, 2):
            acc = a
            o = acc
        with interval(2, None):
            acc = 0.5 * acc[0, 0, -1] + 0.25 * acc[0, 0, -2] + a
            o = acc


def window_halo_defs(a: Field[np.float64], o: Field[np.float64]):
    with computation(FORWARD):
        with interval(0, 1):
            s = a
            acc = a
            o = acc
        with interval(1, None):
            s = a * 2.0
            acc = 0.5 * (s[1, 0, -1] + s[-1, 0, -1]) + a
            o = acc


def two_ms_defs(a: Field[np.float64], b: Field[np.float64], o1: Field[np.float64], o2: Field[np.float64]):
    with computation(PARALLEL), interval(...):
        t = (a[1, 0, 0] + a[-1, 0, 0]) * 0.5
        o1 = t + a
    with computation(FORWARD):
        with interval(0, 1):
            o2 = b + o1
        with interval(1, None):
            o2 = b + o2[0, 0, -1]


def partial_outputs_defs(a: Field[np.float64], o: Field[np.float64], ob: Field[np.float64]):
    with computation(FORWARD):
        with interval(0, 1):
            ob = a * 2.0  # boundary-only write: planes 1..nk-1 untouched
            o = a
        with interval(1, None):
            o = a + 0.5 * o[0, 0, -1]
    with computation(PARALLEL), interval(...):
        if a > 0.0:
            ob = ob + 1.0  # masked write: false lanes untouched


# ---------------------------------------------------------------------------
# the backends (the reference's test_dsl_backends.py)
# ---------------------------------------------------------------------------


def nested_conditional_defs(a: Field[np.float64], o: Field[np.float64], *, thr: np.float64):
    with computation(PARALLEL), interval(...):
        if a > thr:
            if a > thr * 2.0:
                o = a * 4.0
            else:
                o = a * 2.0
        else:
            o = -a


def ij_k_fields_defs(a: Field[np.float64], sfc: Field[np.float64, IJ], prof: Field[np.float64, K],
                     o: Field[np.float64]):
    with computation(PARALLEL), interval(...):
        o = a * prof + sfc


def column_sum_defs(rho: Field[np.float64], colsum: Field[np.float64]):
    with computation(FORWARD):
        with interval(0, 1):
            colsum = rho
        with interval(1, None):
            colsum = colsum[0, 0, -1] + rho


def swap_defs(a: Field[np.float64], o: Field[np.float64]):
    with computation(PARALLEL), interval(...):
        x = a * 1.0
        y = a * 2.0
        x, y = y, x
        o = x - y  # = 2a - a = a


def natives_defs(a: Field[np.float64], o: Field[np.float64]):
    with computation(PARALLEL), interval(...):
        o = min(max(sqrt(abs(a)), 0.1), exp(a) + tanh(a))


# ---------------------------------------------------------------------------
# a field written and read one plane up or down inside one PARALLEL interval
# ---------------------------------------------------------------------------


def temp_vertical_defs(a: Field[np.float64], out: Field[np.float64, IJK]):
    with computation(PARALLEL), interval(0, -1):
        t = a[0, 0, 0] * 2.0
        out = t[0, 0, 1]


def temp_above_and_below_defs(a: Field[np.float64], out: Field[np.float64]):
    with computation(PARALLEL), interval(...):
        t = a * 2.0 + 1.0
        out = t[0, 0, 1] - t[0, 0, -1]  # the temporary reads 0 beyond the domain


def temp_vertical_halo_defs(a: Field[np.float64], out: Field[np.float64]):
    with computation(PARALLEL), interval(...):
        t = a * a - 0.5
        out = t[1, 0, 1] + t[-1, 0, -1] + t[0, 1, 0]


def api_read_below_then_written_defs(a: Field[np.float64], b: Field[np.float64], o: Field[np.float64]):
    with computation(PARALLEL), interval(1, None):
        o = b[0, 0, -1] * 2.0  # the caller's b, one plane down
        b = a + o


def api_written_then_read_above_defs(a: Field[np.float64], b: Field[np.float64], o: Field[np.float64]):
    with computation(PARALLEL), interval(0, -1):
        b = a * 3.0
        o = b[0, 0, 1] + b  # b one plane up, as the first stage left it


def vertical_flux_divergence_defs(q: Field[np.float64], w: Field[np.float64], div: Field[np.float64], *,
                                  dz: np.float64):
    """The vertical divergence of the upwind flux of ``q`` carried by ``w``:
    ``div = (F[k + 1/2] - F[k - 1/2]) / dz``, with ``flux`` the half-level
    flux through each level's lower face (none through the ground or the
    model top, where the temporary reads 0)."""
    with computation(PARALLEL):
        with interval(0, 1):
            wf = 0.5 * (w + w[0, 0, 1])
            div = (max(wf, 0.0) * q + min(wf, 0.0) * q[0, 0, 1]) / dz
        with interval(1, None):
            wf = 0.5 * (w[0, 0, -1] + w)
            flux = max(wf, 0.0) * q[0, 0, -1] + min(wf, 0.0) * q
            div = (flux[0, 0, 1] - flux) / dz


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------


def _phi_o(defs, seed):
    return Case(defs.__name__[:-5], defs, (("phi", "normal"), ("o", "zeros")), halo=1, seed=seed)


def _a_o(defs, seed, start="normal"):
    return Case(defs.__name__[:-5], defs, (("a", start), ("o", "zeros")), seed=seed)


CASES = (
    [_phi_o(d, 1) for d in ONE_FIELD]
    + [Case(d.__name__[:-5], d, ((n0, "normal"), (n1, "normal"), ("o", "zeros")), halo=1, seed=2)
       for d, (n0, n1) in zip(TWO_FIELDS, (("phi", "vel"), ("phi", "vel"), ("u", "v")))]
    + [
        Case("hdiff", hdiff_defs, (("in_phi", "normal"), ("out_phi", "zeros")), (("alpha", 0.07),),
             (("LIM", 0.01),), halo=3, seed=4),
        Case("vadv", vadv_defs, (("a", "small"), ("b", "diag"), ("c", "small"), ("d", "normal"), ("out", "zeros")),
             seed=5),
        Case("vadv_system", vadv_system_defs, (("w", "normal"), ("phi", "normal"), ("a", "zeros"), ("b", "zeros"),
                                               ("c", "zeros"), ("d", "zeros")), (("dt", 0.5), ("dz", 1.5)), seed=6),
        _a_o(overwritten_local_defs, 7),
        _a_o(zero_init_temp_defs, 8),
        _a_o(merge_forward_defs, 9),
        _a_o(merge_backward_defs, 10),
        _a_o(fold_literals_defs, 11),
        _a_o(fold_empty_then_defs, 12),
        _a_o(fold_mod_defs, 13),
        _a_o(negative_zero_defs, 14, "negzero"),
        Case("cse_neighbor_sums", cse_neighbor_sums_defs, (("a", "normal"), ("o", "zeros")), halo=1, seed=20),
        Case("hdiff_smag", hdiff_smag_defs, (("u", "normal"), ("v", "normal"), ("out_u", "zeros"),
                                             ("out_v", "zeros")), (("dt", 0.4),), (("CS", 0.15),), halo=1, seed=21),
        Case("cse_intervening_writes", cse_intervening_writes_defs, (("a", "normal"), ("b", "normal"),
                                                                     ("o", "zeros")), seed=23),
        Case("vadv_boundary", vadv_boundary_defs, (("wcon", "normal"), ("phi", "normal"), ("flux_bot", "normal"),
                                                   ("flux_top", "normal"), ("acc", "zeros"), ("res", "zeros")),
             (("weight", 0.4),), halo=1, seed=30),
        Case("reassociation", reassociation_defs, (("u", "normal"), ("v", "normal"), ("o", "zeros")), seed=32),
        Case("interval_merging_vertical", interval_merging_vertical_defs, (("phi", "normal"), ("o", "zeros")),
             seed=37),
        Case("vintg", vintg_defs, (("rho", "positive"), ("w", "positive"), ("out_dn", "zeros"), ("out_up", "zeros")),
             (("decay", 0.9),), seed=1),
        _a_o(window_depth_two_defs, 3),
        Case("window_halo", window_halo_defs, (("a", "normal"), ("o", "zeros")), halo=1, seed=4),
        Case("two_ms", two_ms_defs, (("a", "normal"), ("b", "normal"), ("o1", "zeros"), ("o2", "zeros")), halo=1,
             seed=5),
        Case("partial_outputs", partial_outputs_defs, (("a", "normal"), ("o", "normal"), ("ob", "normal")), seed=9),
        Case("nested_conditional", nested_conditional_defs, (("a", "normal"), ("o", "zeros")), (("thr", 0.3),),
             domain=(9, 8, 4), seed=5),
        Case("ij_k_fields", ij_k_fields_defs, (("a", "normal"), ("sfc", "normal"), ("prof", "normal"),
                                               ("o", "zeros")), axes=(("sfc", IJ), ("prof", K)), seed=7),
        Case("column_sum", column_sum_defs, (("rho", "abs"), ("colsum", "zeros")), domain=(5, 5, 9), seed=11),
        Case("swap", swap_defs, (("a", "normal"), ("o", "zeros")), domain=(4, 4, 3), seed=2),
        Case("natives", natives_defs, (("a", "normal"), ("o", "zeros")), domain=(6, 5, 4), seed=13),
        Case("temp_vertical", temp_vertical_defs, (("a", "normal"), ("out", "normal")), seed=40),
        Case("temp_above_and_below", temp_above_and_below_defs, (("a", "normal"), ("out", "normal")), seed=41),
        Case("temp_vertical_halo", temp_vertical_halo_defs, (("a", "normal"), ("out", "normal")), halo=1, seed=42),
        Case("api_read_below_then_written", api_read_below_then_written_defs,
             (("a", "normal"), ("b", "normal"), ("o", "normal")), seed=43),
        Case("api_written_then_read_above", api_written_then_read_above_defs,
             (("a", "normal"), ("b", "normal"), ("o", "normal")), seed=44),
        Case("vertical_flux_divergence", vertical_flux_divergence_defs, (("q", "normal"), ("w", "normal"),
                                                                         ("div", "normal")), (("dz", 0.7),), seed=45),
    ]
)
BY_NAME = {c.name: c for c in CASES}
assert len(BY_NAME) == len(CASES), "case names must be unique"


# ---------------------------------------------------------------------------
# the matrices the card runs (chip_smoke.py path M, tests/test_torch_dsl_gpu.py)
# ---------------------------------------------------------------------------

CORPUS_DOMAIN, CORPUS_HALO = (6, 5, 7), 6  # tests/corpus_gen.py: NI, NJ, NK and HALO
CORPUS_TOL = 1e-12  # the reference's property matrix, for its XLA legs
CASE_TOL = 1e-13  # the reference's run_differential


@dataclasses.dataclass
class CardRun:
    """One configuration the card runs: a ``cuda`` stencil, the port's
    ``debug`` stencil at ``opt_level=0`` that is its oracle, and the inputs."""

    label: str
    stencil: object
    oracle: object
    arrays: Dict[str, Tuple[np.ndarray, Tuple[int, ...]]]
    scalars: Dict[str, float]
    domain: Tuple[int, int, int]
    tol: float


def corpus_levels(index: int) -> Tuple[int, ...]:
    """The opt levels of a corpus program's ``cuda`` leg: 0, 3, and 1 or 2
    by index (the reference's Pallas leg)."""
    return (0, 3, 1 if index % 2 == 0 else 2)


def corpus_runs(corpus_dir):
    """Path M1: every corpus program at ``block=(4, 4)`` and ``corpus_levels``,
    with random initial outputs (the reference's ``_corpus_data``).  Returns
    the runs, the programs the ``cuda`` backend rejected and those the
    reference's Pallas limit rejects (a written API field read at a
    horizontal offset)."""
    ni, nj, nk = CORPUS_DOMAIN
    runs, rejected, expected = [], [], []
    for path in sorted(Path(corpus_dir).glob("prog_*.json")):
        index = int(path.stem.split("_")[1])
        defn = ir_json.load_program(path)
        if not ir_json.pallas_compatible(defn):
            expected.append(path.stem)
        rng = np.random.default_rng(index)
        shape = (ni + 2 * CORPUS_HALO, nj + 2 * CORPUS_HALO, nk)
        arrays = {f.name: (rng.normal(size=shape), (CORPUS_HALO, CORPUS_HALO, 0))
                  for f in defn.api_fields if f.is_api}
        scalars = {"s": float(rng.normal())}
        oracle = build_from_definition(defn, "debug", backend_opts={"opt_level": 0})
        try:
            for lvl in corpus_levels(index):
                st = build_from_definition(defn, "cuda", backend_opts={"opt_level": lvl, "block": BLOCK})
                runs.append(CardRun(f"{path.stem}@{lvl}", st, oracle, arrays, scalars, CORPUS_DOMAIN, CORPUS_TOL))
        except GTScriptSemanticError as e:
            if "horizontal offset" not in str(e):
                raise
            rejected.append(path.stem)
    return runs, rejected, expected


def case_runs():
    """Path M2: every case at ``opt_level`` 0 and the default (``None``),
    ``block=(4, 4)``."""
    runs = []
    for case in CASES:
        ext = dict(case.externals)
        oracle = gtscript.stencil("debug", externals=ext, opt_level=0)(case.defs)
        for lvl in (0, None):
            opts = {"block": BLOCK} if lvl is None else {"block": BLOCK, "opt_level": lvl}
            st = gtscript.stencil("cuda", externals=ext, **opts)(case.defs)
            runs.append(CardRun(f"{case.name}@{'default' if lvl is None else lvl}", st, oracle, case.arrays(),
                                dict(case.scalars), case.domain, CASE_TOL))
    return runs


def hold(run: CardRun, device) -> float:
    """Launch ``run``'s kernel once on ``device`` (card-layout storages) and
    hold every field against the oracle on the host; the largest deviation."""
    fields = {n: storage.from_array(a.copy(), backend="cuda", default_origin=o, device=device)
              for n, (a, o) in run.arrays.items()}
    launches = run.stencil.launches
    run.stencil(**fields, **run.scalars, domain=run.domain)
    if run.stencil.launches != launches + 1:
        raise AssertionError(f"{run.label}: the cuda stencil did not launch its kernel")
    host = {n: a.copy() for n, (a, _o) in run.arrays.items()}
    run.oracle(**host, **run.scalars, domain=run.domain, origin={n: o for n, (_a, o) in run.arrays.items()})
    worst = 0.0
    for n, f in fields.items():
        got, want = f.to_numpy(), host[n]
        if not np.allclose(got, want, rtol=run.tol, atol=run.tol, equal_nan=True):
            raise AssertionError(f"{run.label}: the kernel differs from the debug oracle on {n!r} by "
                                 f"{np.nanmax(np.abs(got - want)):.3e} (tolerance {run.tol})")
        worst = max(worst, float(np.nanmax(np.abs(got - want))) if got.size else 0.0)
    return worst
