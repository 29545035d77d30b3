"""The torch port's compiler front half against the reference package.

For every stencil definition the port ships and for the stencil corpus
(``tests/corpus/prog_*.json``): the optimized Implementation IR and the
pass-pipeline decisions equal the reference's at every opt level, and the
generated ``debug``/``numpy`` modules give bit-identical float64 outputs on
the same NumPy inputs.  Also: the port imports neither JAX nor ``repro``.
"""

import pytest

pytest.importorskip("torch", reason="the torch port's tests need PyTorch")

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

import corpus_gen
from repro.core import analysis as r_analysis
from repro.core import frontend as r_frontend
from repro.core import passes as r_passes
from repro.core.stencil import build_from_definition as r_build
from repro.stencils import forecast as r_forecast
from repro.stencils import hdiff as r_hdiff
from repro.stencils import vadv as r_vadv
from repro.stencils import vintg as r_vintg
from repro_torch.core import analysis as t_analysis
from repro_torch.core import frontend as t_frontend
from repro_torch.core import ir_json
from repro_torch.core import passes as t_passes
from repro_torch.core.stencil import build_from_definition as t_build
from repro_torch.stencils import forecast as t_forecast
from repro_torch.stencils import hdiff as t_hdiff
from repro_torch.stencils import vadv as t_vadv
from repro_torch.stencils import vintg as t_vintg

ROOT = Path(__file__).resolve().parent.parent
CORPUS = sorted((Path(__file__).resolve().parent / "corpus").glob("prog_*.json"))

# (name, reference definition, port definition, externals)
DEFINITIONS = [
    ("hdiff", r_hdiff.hdiff_defs, t_hdiff.hdiff_defs, {"LIM": 0.01}),
    ("hdiff_smag", r_hdiff.hdiff_smag_defs, t_hdiff.hdiff_smag_defs, {"CS": 0.15}),
    ("vadv", r_vadv.vadv_defs, t_vadv.vadv_defs, {}),
    ("vadv_system", r_vadv.vadv_system_defs, t_vadv.vadv_system_defs, {}),
    ("vadv_boundary", r_vadv.vadv_boundary_defs, t_vadv.vadv_boundary_defs, {}),
    ("vintg", r_vintg.vintg_defs, t_vintg.vintg_defs, {}),
    ("advect", r_forecast.advect_defs, t_forecast.advect_defs, {}),
    ("euler", r_forecast.euler_defs, t_forecast.euler_defs, {}),
    ("diffuse", r_forecast.diffuse_defs, t_forecast.diffuse_defs, {}),
]


def _definitions(case):
    name, r_def, t_def, ext = case
    return (
        r_frontend.parse_stencil_definition(r_def, externals=dict(ext), name=name),
        t_frontend.parse_stencil_definition(t_def, externals=dict(ext), name=name),
    )


def _decisions(report):
    return [{k: v for k, v in r.items() if k != "seconds"} for r in report]


def _pipelines(r_defn, t_defn, opt_level):
    r_impl, r_rep = r_passes.run_pipeline(r_analysis.analyze(r_defn), **r_passes.split_backend_opts({"opt_level": opt_level})[0])
    t_impl, t_rep = t_passes.run_pipeline(t_analysis.analyze(t_defn), **t_passes.split_backend_opts({"opt_level": opt_level})[0])
    return r_impl, r_rep, t_impl, t_rep


@pytest.mark.parametrize("case", DEFINITIONS, ids=[c[0] for c in DEFINITIONS])
def test_definition_ir_and_pipeline_match_reference(case):
    r_defn, t_defn = _definitions(case)
    # frozen dataclasses of the two packages print alike when they are alike
    assert repr(t_defn) == repr(r_defn)
    for lvl in (0, 1, 2, 3):
        r_impl, r_rep, t_impl, t_rep = _pipelines(r_defn, t_defn, lvl)
        assert repr(t_impl) == repr(r_impl), f"opt_level {lvl}"
        assert repr(_decisions(t_rep)) == repr(_decisions(r_rep)), f"opt_level {lvl}"
        assert repr(t_analysis.sequential_carry_plan(t_impl)) == repr(r_analysis.sequential_carry_plan(r_impl))


@pytest.mark.parametrize("path", CORPUS, ids=[p.stem for p in CORPUS])
def test_corpus_ir_and_pipeline_match_reference(path):
    r_defn = corpus_gen.load_program(path)
    t_defn = ir_json.load_program(path)
    assert repr(t_defn) == repr(r_defn)
    assert ir_json.definition_to_json(t_defn) == corpus_gen.definition_to_json(r_defn)
    for lvl in (0, 3):
        r_impl, r_rep, t_impl, t_rep = _pipelines(r_defn, t_defn, lvl)
        assert repr(t_impl) == repr(r_impl), f"opt_level {lvl}"
        assert repr(_decisions(t_rep)) == repr(_decisions(r_rep)), f"opt_level {lvl}"


def _run_both(r_defn, t_defn, backend, data, scalars, domain, origin):
    outs = []
    for build, defn in ((r_build, r_defn), (t_build, t_defn)):
        st = build(defn, backend)
        fields = {n: a.copy() for n, a in data.items()}
        st(**fields, **scalars, domain=domain, origin=origin)
        outs.append({n: fields[n] for n in st.implementation_ir.written_api_fields()})
    return outs


@pytest.mark.parametrize("backend", ["debug", "numpy"])
def test_definition_outputs_bit_identical(backend):
    rng = np.random.default_rng(5)
    domain, h = (5, 6, 4), 3
    scalars = {"alpha": 0.05, "dt": 0.1, "dz": 0.7, "weight": 0.6, "decay": 0.9, "dx": 1.1, "dy": 0.9}
    for case in DEFINITIONS:
        r_defn, t_defn = _definitions(case)
        names = [f.name for f in r_defn.api_fields if f.is_api]
        shape = (domain[0] + 2 * h, domain[1] + 2 * h, domain[2])
        data = {n: rng.normal(size=shape) for n in names}
        if "b" in data:
            data["b"] = np.abs(data["b"]) + 2.0
        sc = {s.name: scalars[s.name] for s in r_defn.scalars}
        ref, got = _run_both(r_defn, t_defn, backend, data, sc, domain, (h, h, 0))
        assert ref.keys() == got.keys()
        for n in ref:
            np.testing.assert_array_equal(got[n], ref[n], err_msg=f"{case[0]}/{n}")


@pytest.mark.parametrize("path", CORPUS[::2], ids=[p.stem for p in CORPUS[::2]])
def test_corpus_outputs_bit_identical(path):
    r_defn = corpus_gen.load_program(path)
    t_defn = ir_json.load_program(path)
    cn = (corpus_gen.NI, corpus_gen.NJ, corpus_gen.NK)
    h = corpus_gen.HALO
    rng = np.random.default_rng(int(path.stem[-2:]))
    data = {f.name: rng.normal(size=(cn[0] + 2 * h, cn[1] + 2 * h, cn[2])) for f in r_defn.api_fields if f.is_api}
    s = float(rng.normal())
    for backend in ("debug", "numpy"):
        ref, got = _run_both(r_defn, t_defn, backend, data, {"s": s}, cn, (h, h, 0))
        for n in ref:
            np.testing.assert_array_equal(got[n], ref[n], err_msg=f"{backend}/{n}")


_FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.MULTILINE)


def test_port_sources_import_neither_jax_nor_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    scanned = {f.relative_to(ROOT / "src" / "repro_torch").as_posix() for f in files[:-1]}
    assert {"core/autotune.py", "obs/export.py", "obs/flight.py", "obs/metrics.py", "obs/slo.py",
            "runtime/supervise.py", "serving/engine.py", "serving/server.py", "serving/client.py",
            "launch/serve.py", "optim/adamw.py", "optim/clip.py", "optim/schedule.py", "data/pipeline.py",
            "checkpoint/store.py", "runtime/loop.py", "runtime/compression.py", "launch/train.py",
            "parallel/sharding.py", "parallel/staged.py", "launch/specs.py", "launch/dryrun.py",
            "launch/hlo_count.py"} <= scanned
    offenders = [str(f) for f in files if _FORBIDDEN.search(f.read_text())]
    assert offenders == []


def test_port_import_leaves_jax_and_reference_unloaded():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n in ('jax', 'repro') or n.startswith(('jax.', 'repro.')))\n"
        "assert not bad, bad\n"
        "print('clean', len([n for n in sys.modules if n.startswith('repro_torch')]))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("clean")
