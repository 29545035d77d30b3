"""What the port's mirrors of the stencil toolchain's tests share.

``reference_twin(fn)`` is a port definition as the reference's frontend
reads it: the same source and code, with the reference's ``Field`` types in
its signature and the reference's twin of every GTScript function it calls.
So one definition, written once with the port's types, is parsed by both
packages, and the reference's ``debug`` backend at ``opt_level=0`` (the
verbatim lowering) is the oracle the port's backends are held against.

``run_differential`` is the port's side of the reference's
``tests/test_passes.py::run_differential``: the reference's backends map to
the port's as ``jax`` to ``torch`` and ``pallas`` to ``cuda`` (its plain
module on CPU tensors, at the same ``block=(4, 4)`` that the card runs).
"""

from __future__ import annotations

import types

import numpy as np

from repro.core import gtscript as r_gtscript
from repro.core import storage as r_storage
from repro.core.stencil import build_from_definition as r_build
from repro_torch.core import frontend as t_frontend
from repro_torch.core import gtscript as t_gtscript
from repro_torch.core import storage as t_storage

TOL = 1e-13  # the reference's run_differential tolerance
BLOCK = (4, 4)
# the reference's run_differential variants, on the port's backends
VARIANTS = (
    ("debug", "debug", {}),
    ("numpy@0", "numpy", {"opt_level": 0}),
    ("numpy@default", "numpy", {}),
    ("torch@0", "torch", {"opt_level": 0}),
    ("torch@default", "torch", {}),
    ("cuda@0", "cuda", {"opt_level": 0, "block": BLOCK}),
    ("cuda@default", "cuda", {"block": BLOCK}),
)

_TWINS: dict = {}


def _to_reference(value):
    if isinstance(value, t_gtscript._FieldType):
        return r_gtscript.Field[value.dtype, value.axes]
    if isinstance(value, t_gtscript.GTScriptFunction):
        return r_gtscript.function(reference_twin(value.definition))
    return value


def reference_twin(fn):
    """``fn``, a definition or GTScript function written with the port's
    types, as the reference's frontend reads it."""
    twin = _TWINS.get(fn)
    if twin is None:
        names = set(fn.__code__.co_names)
        glob = dict(fn.__globals__)
        glob.update({n: _to_reference(v) for n, v in fn.__globals__.items() if n in names})
        closure = tuple(types.CellType(_to_reference(c.cell_contents)) for c in fn.__closure__ or ())
        twin = types.FunctionType(fn.__code__, glob, fn.__name__, fn.__defaults__, closure or None)
        twin.__kwdefaults__ = fn.__kwdefaults__
        twin.__annotations__ = {n: _to_reference(eval(a, fn.__globals__) if isinstance(a, str) else a)  # noqa: S307
                                for n, a in fn.__annotations__.items()}
        _TWINS[fn] = twin
    return twin


def definitions(fn, externals=None, name=None):
    """(reference Definition IR, port Definition IR) of one definition,
    asserted equal: frozen dataclasses of the two packages print alike
    when they are alike."""
    from repro.core import frontend as r_frontend

    name = name or fn.__name__
    t_defn = t_frontend.parse_stencil_definition(fn, externals=dict(externals or {}), name=name)
    r_defn = r_frontend.parse_stencil_definition(reference_twin(fn), externals=dict(externals or {}), name=name)
    assert repr(t_defn) == repr(r_defn), f"{name}: the port's Definition IR differs from the reference's"
    return r_defn, t_defn


def oracle(r_defn, arrays, scalars, domain):
    """The reference's ``debug`` backend at ``opt_level=0`` on copies of
    ``arrays`` (``{name: (array, origin)}``): every field after the call."""
    st = r_build(r_defn, "debug", backend_opts={"opt_level": 0})
    fs = {n: r_storage.from_array(a.copy(), backend="debug", default_origin=o) for n, (a, o) in arrays.items()}
    st(**fs, **scalars, domain=domain)
    return {n: f.to_numpy() for n, f in fs.items()}


def run_port(defn, backend, opts, arrays, scalars, domain):
    """One port backend on copies of ``arrays``: every field after the call
    (``torch`` and ``cuda`` storages on the CPU)."""
    from repro_torch.core.stencil import build_from_definition

    st = build_from_definition(defn, backend, backend_opts=dict(opts))
    device = "cpu" if backend in ("torch", "cuda") else None
    fs = {n: t_storage.from_array(a.copy(), backend=backend, default_origin=o, device=device)
          for n, (a, o) in arrays.items()}
    st(**fs, **scalars, domain=domain)
    if backend in ("torch", "cuda"):
        assert st.launches == 0  # a CPU tensor runs the plain module
    return {n: f.to_numpy() for n, f in fs.items()}


def run_differential(defs, fields_np, scalars, domain, externals=None, variants=VARIANTS):
    """Every port variant against the reference's oracle, on the same
    NumPy inputs, within the reference's tolerance; returns the outputs
    by variant."""
    r_defn, t_defn = definitions(defs, externals)
    want = oracle(r_defn, fields_np, scalars, domain)
    results = {}
    for key, backend, opts in variants:
        got = run_port(t_defn, backend, opts, fields_np, scalars, domain)
        for n in want:
            np.testing.assert_allclose(got[n], want[n], rtol=TOL, atol=TOL,
                                       err_msg=f"{key} disagrees with the reference's debug oracle on {n!r}")
        results[key] = got
    return results


def run_case(case, variants=VARIANTS):
    """``run_differential`` on a ``torch_stencil_cases.Case``."""
    return run_differential(case.defs, case.arrays(), dict(case.scalars), case.domain, dict(case.externals),
                            variants)


def decisions(report):
    """A pass report without its timings."""
    return [{k: v for k, v in r.items() if k != "seconds"} for r in report]

