"""Gradients of the port's training path on the CPU, against the reference.

* ``RGLRUScan`` (the RG-LRU scan with its gradient: the scan run backwards
  in time) against ``jax.vjp`` through the reference's associative scan
  (``repro/models/rglru.py::_rglru_scan``), with and without ``h0``;
* every one of the 10 reduced configs: the loss and every leaf's gradient
  against ``jax.grad`` of the reference's ``loss`` (remat on in both), on
  the reference's weights carried across after the true-fan-in rescale of
  ``tests/test_torch_lm_families.py``;
* one ``make_train_step`` (two microbatches, clip, warmup, AdamW with
  weight decay) against the reference's, compared through
  ``convert.params_to_reference``;
* ``remat=True`` gradients equal to ``remat=False`` bit for bit.

Tolerances.  The loss at 1e-5 of its value (``_near``).  A leaf's gradient
within ``GRAD_REL`` of that leaf's largest reference gradient plus
``GRAD_FLOOR`` of the largest gradient of the model: the floor is for leaves
whose exact gradient is zero, Whisper's key biases (a softmax does not see a
bias added to every key), where both packages return rounding noise of
about 3e-8 against a largest gradient of 1.4.  Measured: every leaf of the
10 configs within 2e-6 of its largest gradient.
"""

import pytest

pytest.importorskip("torch", reason="the torch port's tests need PyTorch")

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_arch as r_get_arch
from repro.configs import list_archs as r_list_archs
from repro.models import build_model as r_build_model
from repro.models import rglru as r_rglru
from repro.optim import adamw_init as r_adamw_init
from repro.runtime.loop import TrainState as RTrainState
from repro.runtime.loop import make_train_step as r_make_train_step
from repro_torch.configs import get_arch
from repro_torch.kernels.rglru.ops import RGLRUScan, rglru_scan
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_reference, params_to_reference
from repro_torch.models.layers import map_tree
from repro_torch.optim import adamw_init
from repro_torch.runtime.loop import TrainState, make_train_step
from test_torch_lm_families import _batch, _near, _ref_tree, _true_fan_in

ARCHS = list(r_list_archs())
GRAD_REL = 1e-5
GRAD_FLOOR = 1e-6


def _flat(tree, path=""):
    """{path: numpy leaf} of a nested dict."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{path}/{k}" if path else k))
        return out
    return {path: np.asarray(tree, np.float64)}


def _grad_tolerances(ref: dict) -> dict:
    floor = GRAD_FLOOR * max(np.abs(v).max() for v in ref.values())
    return {k: GRAD_REL * np.abs(v).max() + floor for k, v in ref.items()}


def _hold_grads(got: dict, ref: dict):
    assert sorted(got) == sorted(ref)
    tol = _grad_tolerances(ref)
    for k, r in ref.items():
        assert got[k].shape == r.shape, k
        err = np.abs(got[k] - r).max()
        assert err <= tol[k], (k, err, tol[k])


def _setup(arch):
    r_cfg, t_cfg = r_get_arch(arch).reduced, get_arch(arch).reduced
    r_model, t_model = r_build_model(r_cfg), build_model(t_cfg)
    tree = _true_fan_in(_ref_tree(r_model.init_params(jax.random.PRNGKey(2))), r_cfg)
    return r_model, tree, t_model


def _port_grads(params) -> dict:
    return _flat(params_to_reference(map_tree(lambda _p, x: x.grad, params.to_tree(data=False))))


# ---------------------------------------------------------------------------
# the scan's gradient
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_scan_grads_match_reference(with_h0):
    rng = np.random.default_rng(5)
    shape = (2, 37, 24)
    a = rng.uniform(0.05, 0.999, size=shape).astype(np.float32)
    b = rng.normal(size=shape).astype(np.float32)
    dy = rng.normal(size=shape).astype(np.float32)
    h0 = rng.normal(size=shape[::2]).astype(np.float32) if with_h0 else None

    def ref_scan(a_, b_, h0_):
        return r_rglru._rglru_scan(b_, a_, h0_)[0]

    args = (jnp.asarray(a), jnp.asarray(b), None if h0 is None else jnp.asarray(h0))
    y_ref, vjp = jax.vjp(lambda a_, b_: ref_scan(a_, b_, args[2]), *args[:2]) if h0 is None else \
        jax.vjp(ref_scan, *args)
    grads_ref = vjp(jnp.asarray(dy))

    ta, tb = torch.from_numpy(a).requires_grad_(), torch.from_numpy(b).requires_grad_()
    th0 = None if h0 is None else torch.from_numpy(h0).requires_grad_()
    y = rglru_scan(ta, tb, th0)
    assert y.grad_fn is not None and type(y.grad_fn).__name__ == f"{RGLRUScan.__name__}Backward"
    y.backward(torch.from_numpy(dy))
    _near(y.detach(), y_ref)
    got = (ta.grad, tb.grad) + (() if th0 is None else (th0.grad,))
    assert len(got) == len(grads_ref)
    for g, r in zip(got, grads_ref):
        _near(g, r)


def test_rglru_scan_zero_decay_gradient_is_exact():
    """a ≡ 0: y = b, so db = dy and dh0 = 0 exactly."""
    rng = np.random.default_rng(6)
    b = torch.from_numpy(rng.normal(size=(2, 9, 8)).astype(np.float32)).requires_grad_()
    h0 = torch.from_numpy(rng.normal(size=(2, 8)).astype(np.float32)).requires_grad_()
    a = torch.zeros((2, 9, 8), requires_grad=True)
    dy = torch.from_numpy(rng.normal(size=(2, 9, 8)).astype(np.float32))
    rglru_scan(a, b, h0).backward(dy)
    assert torch.equal(b.grad, dy) and torch.equal(h0.grad, torch.zeros_like(h0))


# ---------------------------------------------------------------------------
# the models' gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    r_model, tree, t_model = _setup(arch)
    batch = _batch(t_model.cfg, 2, 12)
    r_batch = {k: jnp.asarray(v) for k, v in batch.items()}
    grad_fn = jax.jit(jax.value_and_grad(lambda p, b: r_model.loss(p, b, remat=True), has_aux=True))
    (r_loss, _), r_grads = grad_fn(jax.tree_util.tree_map(jnp.asarray, tree), r_batch)

    params = params_from_reference(tree, device="cpu").trainable_()
    loss, _ = t_model.loss(params, {k: torch.from_numpy(v) for k, v in batch.items()}, remat=True)
    loss.backward()
    _near(loss.detach(), r_loss)
    _hold_grads(_port_grads(params), _flat(jax.tree_util.tree_map(np.asarray, r_grads)))


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gradients_equal_no_remat(arch):
    model = build_model(get_arch(arch).reduced)
    batch = {k: torch.from_numpy(v) for k, v in _batch(model.cfg, 2, 12).items()}
    grads = []
    for remat in (False, True):
        params = model.init_params(torch.Generator().manual_seed(3), device="cpu").trainable_()
        model.loss(params, batch, remat=remat)[0].backward()
        grads.append([p.grad for _path, p in params.leaves()])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# one training step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "moonshot-v1-16b-a3b"])
def test_train_step_matches_reference(arch):
    """One step of two microbatches: metrics, AdamW's moments and the new
    parameters against the reference's.  The first AdamW step moves each
    entry by lr·g/(|g| + eps) (m̂/√v̂ = g/|g|), so an entry whose gradient
    lies within the gradient tolerance ``tol`` of zero may move either way
    in either package: those are held within 2·lr; the others within 1e-6
    plus what ``tol`` moves the step, lr·eps·tol/(|g| + eps)².
    RecurrentGemma's tail layer and final norm hold the weight-decay rank
    rule (undecayed vectors beside decayed stacked ones)."""
    lr, b1, b2 = 1e-3, 0.9, 0.95
    r_model, tree, t_model = _setup(arch)
    batch = _batch(t_model.cfg, 4, 12)
    kw = dict(base_lr=lr, warmup_steps=1, total_steps=10, microbatches=2)

    r_params = jax.tree_util.tree_map(jnp.asarray, tree)
    r_state = RTrainState(step=jnp.zeros((), jnp.int32), params=r_params, opt=r_adamw_init(r_params))
    r_state, r_metrics = jax.jit(r_make_train_step(r_model, **kw))(r_state, {k: jnp.asarray(v) for k, v in batch.items()})

    params = params_from_reference(tree, device="cpu").trainable_()
    state = TrainState(step=torch.zeros((), dtype=torch.int32), params=params, opt=adamw_init(params))
    state, metrics = make_train_step(t_model, **kw)(state, {k: torch.from_numpy(v) for k, v in batch.items()})

    assert int(state.step) == int(state.opt.step) == 1
    assert sorted(metrics) == sorted(r_metrics)
    for k in ("loss", "ce_loss", "grad_norm", "lr"):
        _near(metrics[k].reshape(()), r_metrics[k])
    r_m, r_v = (_flat(jax.tree_util.tree_map(np.asarray, t)) for t in (r_state.opt.m, r_state.opt.v))
    m, v = (_flat(params_to_reference(t)) for t in (state.opt.m, state.opt.v))
    g_ref = {k: x / (1 - b1) for k, x in r_m.items()}  # the clipped gradient
    tol = _grad_tolerances(g_ref)
    _hold_grads({k: x / (1 - b1) for k, x in m.items()}, g_ref)
    for k in v:  # v = (1 - b2)·g²: |Δv| <= (1 - b2)·tol·(2|g| + tol)
        assert np.abs(v[k] - r_v[k]).max() <= (1 - b2) * np.max(tol[k] * (2 * np.abs(g_ref[k]) + tol[k])), k
    new, r_new = _flat(params_to_reference(state.params)), _flat(jax.tree_util.tree_map(np.asarray, r_state.params))
    eps = 1e-8
    for k, r in r_new.items():
        g = np.abs(g_ref[k])
        sure = g > tol[k]
        err = np.abs(new[k] - r)
        assert np.all(err[sure] <= 1e-6 + lr * eps * tol[k] / (g[sure] + eps) ** 2), k
        assert err.max() <= 2 * lr + 1e-6, k
