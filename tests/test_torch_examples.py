"""The port's examples (``examples/*_torch.py``) against the reference's
(``examples/*.py``), both imported from their files and run on the same
NumPy inputs at small sizes, the port with ``--device cpu``:

* quickstart: every backend of the port within 1e-12 of every backend of
  the reference;
* climate_model: the program's and the eager driver's phi within 1e-10 of
  the reference's after ``nt`` steps, and the ensemble's statistics within
  1e-12 of the reference's, both ensembles started from the reference's
  perturbed members;
* serve_forecast: every served response within 1e-12 of the reference's
  sequential run of the same request (``tests/test_torch_serving.py``'s
  tolerance);
* train_lm: the first step's loss within 1e-5 of the reference's, at a
  reduced width, on the reference's weights carried by ``models.convert``.

Each example's default device is the card: without one it raises unless
``--device cpu`` is given.
"""

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch", reason="the torch port's tests need PyTorch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"
PORTS = ("quickstart", "climate_model", "serve_forecast", "train_lm")


def _load(name: str):
    spec = importlib.util.spec_from_file_location(f"example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def examples():
    return {n: (_load(n), _load(f"{n}_torch")) for n in PORTS}


def test_quickstart_backends_agree_with_the_reference(examples):
    ref, port = examples["quickstart"]
    from repro.core import gtscript as r_gtscript
    from repro.core import storage as r_storage

    data = port.smooth_input()
    got = port.main(["--device", "cpu"])["results"]
    assert sorted(got) == ["cuda", "debug", "numpy", "torch"]
    for backend in ("debug", "numpy", "jax"):
        st = r_gtscript.stencil(backend=backend)(ref.smooth_defs)
        i = r_storage.from_array(data, backend=backend, default_origin=(1, 1, 0))
        o = r_storage.zeros(data.shape, backend=backend, default_origin=(1, 1, 0))
        st(i, o, weight=np.float64(port.WEIGHT))
        want = np.asarray(o.to_numpy())
        for b, out in got.items():
            np.testing.assert_allclose(out, want, rtol=1e-12, atol=1e-12, err_msg=f"port {b} vs reference {backend}")


CLIMATE_DOM, CLIMATE_NT = (16, 12, 8), 4


def _ref_climate(ref, driver: str):
    dom = CLIMATE_DOM
    scalars = dict(dt=np.float64(0.1), dx=np.float64(1.0), dy=np.float64(1.0), dtdz=np.float64(0.1),
                   alpha=np.float64(0.05))
    stencils = ref.build_stencils("numpy")
    fields = ref.make_fields("numpy", *dom)
    if driver == "eager":
        phi = ref.run_eager(stencils, fields, dom, CLIMATE_NT, scalars)
    else:
        phi = ref.run_program(ref.make_program(stencils, "numpy", dom), fields, CLIMATE_NT, scalars)
    return np.asarray(phi)


@pytest.mark.parametrize("driver", ["program", "eager"])
def test_climate_model_drivers_agree_with_the_reference(examples, driver):
    ref, port = examples["climate_model"]
    nx, ny, nz = CLIMATE_DOM
    args = ["--nx", str(nx), "--ny", str(ny), "--nz", str(nz), "--nt", str(CLIMATE_NT), "--device", "cpu"]
    out = port.main(args + ["--compare"])
    want = _ref_climate(ref, driver)
    assert np.abs(out[driver]["phi"] - want).max() <= 1e-10
    assert out["max_deviation"] <= 1e-10


def test_climate_model_ensemble_statistics_agree_with_the_reference(examples):
    ref, port = examples["climate_model"]
    from repro import ensemble as r_ensemble

    members, dom, nt = 3, CLIMATE_DOM, 2
    scalars = dict(dt=np.float64(0.1), dx=np.float64(1.0), dy=np.float64(1.0), dtdz=np.float64(0.1),
                   alpha=np.float64(0.05))
    r_fields = ref.make_fields("jax", *dom)
    r_phi0 = np.asarray(r_ensemble.perturb(r_fields["phi"], members, seed=0, amplitude=1e-3,
                                           perturb_member0=False))
    r_phi, r_stats = ref.run_ensemble(ref.make_program(ref.build_stencils("jax"), "jax", dom),
                                      r_fields, nt, scalars, members)
    fields = port.make_fields("torch", port.field_arrays(*dom), torch.device("cpu"))
    batched = port.member_fields(fields, members, batched_phi=r_phi0)
    stats = port.run_ensemble(port.climate.build_program("torch", dom), batched, nt,
                              dict(port.climate.DEFAULT_SCALARS), members)
    assert np.abs(batched["phi"].to_numpy() - np.asarray(r_phi)).max() <= 1e-12
    for k in ("mean", "spread", "prob"):
        assert np.abs(stats[k].to_numpy() - np.asarray(r_stats[k])).max() <= 1e-12, k


def test_serve_forecast_responses_agree_with_the_reference(examples):
    ref, port = examples["serve_forecast"]
    from repro.stencils.forecast import build_forecast_step, make_forecast_fields

    out = port.main(["--requests", "3", "--steps", "4", "--device", "cpu"])
    step = build_forecast_step("jax", ref.DOM)
    templates, scalars = make_forecast_fields("jax", ref.DOM)
    for phi0, got in zip(out["requests"], out["finals"]):
        want = ref.run_sequentially(step, templates, scalars, phi0, 4)
        assert np.abs(got - want).max() <= 1e-12


def test_train_lm_first_step_loss_agrees_with_the_reference(examples, tmp_path):
    ref, port = examples["train_lm"]
    from repro.data.pipeline import SyntheticLMDataset as RDataset
    from repro.models import build_model as r_build_model
    from repro.optim import adamw_init as r_adamw_init
    from repro.runtime.loop import TrainState as RTrainState
    from repro.runtime.loop import make_train_step as r_make_train_step
    from repro_torch.models.convert import params_from_reference

    small = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=512)
    batch, seq, lr, steps = 2, 16, 6e-4, 2
    r_cfg = dataclasses.replace(ref.CFG_100M, **small)
    r_model = r_build_model(r_cfg)
    r_params = r_model.init_params(jax.random.PRNGKey(0))
    r_state = RTrainState(step=jnp.zeros((), jnp.int32), params=r_params, opt=r_adamw_init(r_params))
    r_step = jax.jit(r_make_train_step(r_model, base_lr=lr, warmup_steps=20, total_steps=steps))
    r_batch = RDataset(vocab=r_cfg.vocab, seq_len=seq, global_batch=batch).batch_at(0)
    _, r_metrics = r_step(r_state, {k: jnp.asarray(v) for k, v in r_batch.items()})

    carried = params_from_reference(jax.tree_util.tree_map(np.asarray, r_params), device="cpu")
    out = port.train(dataclasses.replace(port.CFG_100M, **small), steps=steps, batch=batch, seq=seq, lr=lr,
                     ckpt_dir=tmp_path / "ckpt", metrics_out=tmp_path / "metrics.json", device=torch.device("cpu"),
                     params=carried)
    assert out["start"] == 0 and len(out["losses"]) == steps
    assert abs(out["losses"][0] - float(r_metrics["loss"])) <= 1e-5
    assert out["exact_params"] == out["active_params"]
    assert (tmp_path / "metrics.json").exists()


@pytest.mark.parametrize("name", PORTS)
def test_example_defaults_to_the_card(examples, name, monkeypatch):
    """Without ``--device cpu`` an example needs a GPU: on a host without one
    it raises before it runs anything, and says to pass the host."""
    _ref, port = examples[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.main([])
