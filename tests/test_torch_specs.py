"""The port's input specs and sharding trees against the reference's, for all
32 (arch × shape) cells of the registry.

``input_specs``, ``cache_specs`` and ``train_state_specs`` give meta tensors
with the reference's shapes and dtypes (the reference's through
``jax.eval_shape``: nothing is allocated on either side).  Every sharding
tree equals the reference's spec leaf for leaf on the production meshes
16 x 16 and 2 x 16 x 16.  The reference builds ``NamedSharding``s over a jax
mesh of 256 or 512 devices; to read its specs without one, the name
``NamedSharding`` inside ``repro.launch.specs`` is patched for each test's
duration to keep the bare spec, and the reference is given a stand-in mesh
(axis names and shape only).  A stacked reference leaf ``(L, ...)`` is each
of the port's per-layer leaves, its layer axis unsharded.
"""

import types

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch", reason="the torch port's tests need PyTorch")

from repro.configs import get_arch as r_get_arch  # noqa: E402
from repro.configs import get_shape as r_get_shape  # noqa: E402
from repro.launch import specs as r_specs  # noqa: E402
from repro.models import build_model as r_build_model  # noqa: E402
from repro_torch.configs import get_arch, get_shape, list_archs  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.layers import tree_leaves  # noqa: E402
from repro_torch.parallel.sharding import AbstractMesh  # noqa: E402

CELLS = [(a, s) for a in list_archs() for s in get_arch(a).shapes]
MESHES = {"16x16": ((16, 16), ("data", "model")), "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def test_the_registry_has_32_cells():
    assert len(CELLS) == 32
    assert CELLS == [(a, s) for a in list_archs() for s in r_get_arch(a).shapes]


@pytest.fixture
def bare_specs(monkeypatch):
    """The reference's sharding functions returning bare PartitionSpecs."""
    monkeypatch.setattr(r_specs, "NamedSharding", lambda mesh, spec: spec)


def _ref_flat(tree):
    """{path: leaf} of a jax pytree, paths joined with '/' like the port's."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)

    def key(k):
        for attr in ("key", "name", "idx"):
            if hasattr(k, attr):
                return str(getattr(k, attr))
        return str(k)

    return {"/".join(key(k) for k in path): leaf for path, leaf in flat}


def _unlayered(path: str) -> str:
    """A port path with the per-layer list indices of ``blocks``/``groups`` dropped."""
    parts = path.split("/")
    return "/".join(p for i, p in enumerate(parts) if not (p.isdigit() and i and parts[i - 1] in ("blocks", "groups")))


def _same_shapes(port_tree, ref_tree):
    ref = _ref_flat(ref_tree)
    port = tree_leaves(port_tree)
    assert {_unlayered(p) for p, _t in port} == set(ref)
    for path, t in port:
        r = ref[_unlayered(path)]
        stacked = _unlayered(path) != path
        assert tuple(r.shape[int(stacked):]) == tuple(t.shape), path
        assert str(np.dtype(r.dtype)) == str(t.dtype).replace("torch.", ""), path
        assert t.device.type == "meta", path


def _same_specs(port_tree, ref_tree):
    ref = _ref_flat(ref_tree)
    port = tree_leaves(port_tree)
    assert {_unlayered(p) for p, _s in port} == set(ref)
    for path, sh in port:
        want = tuple(ref[_unlayered(path)])
        if _unlayered(path) != path:
            assert want[0] is None
            want = want[1:]
        want = want + (None,) * (len(sh.spec) - len(want))
        assert sh.spec == want, path


@pytest.mark.parametrize("arch,shape_id", CELLS)
def test_input_specs_match_reference(arch, shape_id):
    got, ref = specs.input_specs(arch, shape_id), r_specs.input_specs(arch, shape_id)
    assert set(got) == set(ref)
    _same_shapes(got["batch"], ref["batch"])
    if "cache" in ref:
        _same_shapes(got["cache"], ref["cache"])


@pytest.mark.parametrize("arch", list_archs())
def test_train_state_specs_match_reference(arch):
    got = specs.train_state_specs(build_model(get_arch(arch).full))
    ref = r_specs.train_state_specs(r_build_model(r_get_arch(arch).full))
    _same_shapes(got.params, ref.params)
    for name in ("m", "v"):
        _same_shapes(getattr(got.opt, name), getattr(ref.opt, name))
    assert got.step.dtype == torch.int32 and got.opt.step.dtype == torch.int32


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch,shape_id", CELLS)
def test_sharding_trees_match_reference(bare_specs, arch, shape_id, mesh_name):
    shape, names = MESHES[mesh_name]
    r_mesh = types.SimpleNamespace(axis_names=names, devices=np.empty(shape, dtype=np.int8))
    mesh = AbstractMesh(names, shape)
    cfg, r_cfg, cell = get_arch(arch).full, r_get_arch(arch).full, get_shape(shape_id)
    model, r_model = build_model(cfg), r_build_model(r_cfg)
    if cell.kind == "train":
        st, r_st = specs.state_shardings(model, mesh), r_specs.state_shardings(r_model, r_mesh)
        _same_specs(st.params, r_st.params)
        _same_specs(st.opt.m, r_st.opt.m)
        _same_specs(st.opt.v, r_st.opt.v)
        assert st.step.spec == tuple(r_st.step) == ()
        b = specs.input_specs(arch, shape_id)["batch"]
        _same_specs(specs.batch_shardings(mesh, b),
                    r_specs.batch_shardings(r_mesh, r_specs.input_specs(arch, shape_id)["batch"]))
        return
    _same_specs(specs.param_shardings(model, mesh), r_specs.param_shardings(r_model, r_mesh))
    r_cell = r_get_shape(shape_id)
    b = specs.serve_input_specs(cfg, cell.kind, cell.seq_len, cell.global_batch)
    r_b = r_specs.serve_input_specs(r_cfg, r_cell.kind, r_cell.seq_len, r_cell.global_batch)
    _same_specs(specs.serve_batch_shardings(mesh, b), r_specs.serve_batch_shardings(r_mesh, r_b))
    c = specs.cache_specs(model, cell.global_batch, cell.seq_len)
    r_c = r_specs.cache_specs(r_model, r_cell.global_batch, r_cell.seq_len)
    _same_specs(specs.cache_shardings(mesh, c), r_specs.cache_shardings(r_mesh, r_c))
