"""CPU tests of the benchmark: the reference against the port's ``debug``
backend, the check's measure, the imports, the count, the data files, and
the command without a card (the control and the faults:
``test_bench_faults.py``).  Run: ``python -m pytest -q bench/tests``."""

from __future__ import annotations

import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench"
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from bench import count  # noqa: E402
from bench.inputs.climate import Inputs  # noqa: E402
from bench.reference import climate as ref  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SCALARS = {"dt": 0.1, "dx": 1.0, "dy": 1.0, "dz": 1.0, "alpha": 0.05}


def _benchmark():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _config(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


# (a) the reference against the port's debug backend


@pytest.mark.parametrize("members", [1, 3])
def test_reference_matches_the_ports_debug_backend(members):
    from repro_torch.core import storage
    from repro_torch.stencils import climate

    dom, h, steps = (9, 7, 6), 3, 4
    inputs = Inputs(dom, 5, "cpu")
    st = climate.build_stencils("debug")
    ref_phi = torch.stack([inputs.phi(m) for m in range(members)])
    got = []
    for m in range(members):
        f = {n: storage.storage_for_domain(dom, (h, h, 0), backend="debug") for n in climate.FIELD_NAMES}
        for n in ("u", "v", "w"):
            f[n].data[h:-h, h:-h, :] = getattr(inputs, n)().permute(1, 2, 0).numpy()
        f["phi"].data[h:-h, h:-h, :] = inputs.phi(m).permute(1, 2, 0).numpy()
        for _ in range(steps):
            climate.eager_step(st, f, dom, SCALARS)
        got.append(torch.from_numpy(np.asarray(f["phi"].data[h:-h, h:-h, :])).permute(2, 0, 1))
    want = ref.run(ref_phi, inputs.u(), inputs.v(), inputs.w(), SCALARS, steps)
    torch.testing.assert_close(torch.stack(got), want, rtol=1e-13, atol=1e-14)
    assert float((want - ref_phi).abs().max()) > 1e-3  # the steps moved the state


def test_the_gap_holds_each_level_plane_at_its_own_scale():
    from bench.checks.state_gap import plane_gap

    want = torch.ones((2, 3, 8, 6), dtype=torch.float64)
    want[1, 2] *= 1e8  # one plane grown by eight orders, as the top levels grow over a window
    got = want.clone()
    assert plane_gap(got, want) == 0.0
    got[0, 1, 4, 3] += 1e-6  # a millionth on a plane of magnitude 1
    assert plane_gap(got, want) == pytest.approx(1e-6, rel=1e-6)
    assert float((got - want).abs().max() / want.abs().max()) < 1e-13  # one global scale would miss it
    got[1, 2, 0, 0] = float("nan")
    assert plane_gap(got, want) == float("inf")


# (b) imports


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _top(name: str) -> str:
    return name.split(".")[0]


def test_no_module_of_the_benchmark_imports_jax_or_the_reference_package():
    for path in BENCH.rglob("*.py"):
        if "tests" in path.relative_to(BENCH).parts:
            continue
        tops = {_top(n) for n in _imports(path)}
        assert not tops & {"jax", "jaxlib", "flax", "repro"}, path


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        tops = {_top(n) for n in _imports(path)}
        assert tops <= {"__future__", "typing", "torch"}, (path, tops)


def test_a_rehearsal_loads_neither_jax_nor_the_reference_package():
    out = subprocess.run([sys.executable, str(BENCH / "tests" / "rehearse.py"), "cosmo1.program"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["banned"] == [] and res["correct"] is True


# (c) the count


def test_count_at_cosmo1():
    cfg = _config("cosmo1")
    ni, nj, nk = 1158, 774, 80
    field = ni * nj * nk * 8
    nbytes = (ni + 2) * (nj + 2) * nk * 8 + 3 * field + field
    per_point = 10 + 2 + 7 + 17 + 8  # inner levels: advect, euler, diffuse, vadv_system, vadv
    ops = ni * nj * ((nk - 2) * per_point + (10 + 2 + 7 + 8 + 4) + (10 + 2 + 7 + 9 + 6))
    work = count.step_work(cfg)
    assert work == {"bytes": float(nbytes), "ops": float(ops)}
    least = count.least_seconds(cfg)
    assert least["bound"] == "bytes"
    assert least["seconds"] == pytest.approx(nbytes / 3.35e12, rel=1e-12)
    assert least["seconds"] == pytest.approx(0.8569e-3, rel=1e-3)


def test_count_at_cosmoe_reads_the_winds_once():
    cfg = _config("cosmoe")
    ni, nj, nk, m = 582, 390, 60, 21
    field = ni * nj * nk * 8
    nbytes = m * (ni + 2) * (nj + 2) * nk * 8 + 3 * field + m * field
    assert count.step_work(cfg)["bytes"] == float(nbytes)
    assert count.least_seconds(cfg)["seconds"] == pytest.approx(nbytes / 3.35e12, rel=1e-12)


def test_count_divides_a_split_domain_over_its_chips():
    one, four = _config("cosmo1"), _config("cosmo1e")
    assert four["mesh"] == [1, 2, 2]
    w = count.step_work(four)
    assert count.least_seconds(four)["seconds"] == pytest.approx(w["bytes"] / 4 / 3.35e12, rel=1e-12)
    assert w["ops"] == 11 * count.step_work(one)["ops"]


# (d) the data files and the names


def test_every_cell_finds_its_files():
    bench = _benchmark()
    configs = {c["name"]: c for c in bench["configs"]}
    for wl in bench["workloads"]:
        assert wl["config"] in configs
        assert (ROOT / configs[wl["config"]]["file"]).is_file()
        traffic = json.loads((BENCH / "traffic" / f"{wl['traffic']}.json").read_text())
        assert (BENCH / "drivers" / f"{traffic['driver']}.py").is_file()
        assert (BENCH / "loops" / f"{traffic['loop']}.py").is_file()
        cfg = json.loads((ROOT / configs[wl["config"]]["file"]).read_text())
        for key, kind in (("inputs", "inputs"), ("reference", "reference"), ("check", "checks")):
            assert (BENCH / kind / f"{cfg[key]}.py").is_file()
        limits = json.loads((BENCH / "workloads" / f"{wl['name']}.json").read_text())["limits"]
        assert set(limits) == {"start_gap", "last_gap"}
        metrics = [m for m in bench["per_layer"] if wl["name"] in m["workloads"]]
        assert metrics
        for m in metrics:
            family = m["name"][: -len(wl["name"]) - 1]
            assert m["name"] == f"{family}.{wl['name']}"
            assert (BENCH / "metrics" / f"{family}.py").is_file()
        e2e = [m["name"] for m in bench["end_to_end"] if wl["name"] in m.get("workloads", [wl["name"]])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert all((BENCH / "metrics" / f"{n}.py").is_file() for n in e2e)
        assert all(m["moves"] in e2e for m in metrics)


def test_names_and_units_use_the_allowed_characters():
    bench = _benchmark()
    names = [c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]]
    names += [w["traffic"] for w in bench["workloads"]] + [w["config"] for w in bench["workloads"]]
    metrics = bench["end_to_end"] + bench["per_layer"]
    names += [m["name"] for m in metrics]
    for n in names:
        assert NAME.match(n), n
    for m in metrics:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    assert len({m["name"] for m in metrics}) == len(metrics)
    for w in bench["workloads"]:
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


# (e) no card: no result


def test_the_command_without_a_card_exits_non_zero_and_prints_no_result():
    cmd = [sys.executable, "bench/run.py", "--workload", "cosmo1.program", "--seed", str(2**33),
           "--seconds", "1", "--trace", "0"]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode != 0
    assert "metrics" not in out.stdout and "step_ms" not in out.stdout
