"""The port's logical-axis rules against the reference's.

For every architecture's full and reduced config, every parameter leaf's
spec under the port's ``DEFAULT_RULES`` equals the reference's
``mesh_axes`` on the same (stand-in) mesh: (2, 2), (1, 4), (2, 2, 2),
(16, 16) and (2, 16, 16).  The reference is asked with an object that has
only ``axis_names`` and ``devices.shape``, the port with an
``AbstractMesh``: neither needs a device or a process group.  A stacked
reference leaf ``(L, ...)`` is each of the port's per-layer leaves, its
layer axis unsharded.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch", reason="the torch port's tests need PyTorch")

from repro.configs import get_arch as r_get_arch  # noqa: E402
from repro.models import build_model as r_build_model  # noqa: E402
from repro.models.layers import ParamSpec as RParamSpec  # noqa: E402
from repro.parallel import sharding as r_sharding  # noqa: E402
from repro_torch.configs import get_arch, list_archs  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.layers import tree_leaves  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402
from repro_torch.parallel.sharding import (  # noqa: E402
    DEFAULT_RULES,
    AbstractMesh,
    LogicalAxisRules,
    NamedSharding,
    axis_rules,
    current_rules,
    logical_spec,
    with_logical_constraint,
)

MESHES = {
    (2, 2): ("data", "model"),
    (1, 4): ("data", "model"),
    (2, 2, 2): ("pod", "data", "model"),
    (16, 16): ("data", "model"),
    (2, 16, 16): ("pod", "data", "model"),
}


def standin(shape, names):
    """What the reference's rules read of a jax mesh."""
    return types.SimpleNamespace(axis_names=names, devices=np.empty(shape, dtype=np.int8))


def _ref_specs(tree, path=""):
    """(path, ParamSpec) of the reference's spec tree (dicts)."""
    if isinstance(tree, RParamSpec):
        return [(path, tree)]
    return [leaf for k, v in tree.items() for leaf in _ref_specs(v, f"{path}/{k}" if path else k)]


def _unlayered(path: str) -> str:
    return "/".join(p for p in path.split("/") if not p.isdigit())


@pytest.mark.parametrize("arch", list_archs())
@pytest.mark.parametrize("which", ["full", "reduced"])
def test_every_param_spec_matches_reference(arch, which):
    ref = dict(_ref_specs(r_build_model(getattr(r_get_arch(arch), which)).param_specs()))
    port = tree_leaves(build_model(getattr(get_arch(arch), which)).param_specs())
    assert {_unlayered(p) for p, _s in port} == set(ref)
    for shape, names in MESHES.items():
        r_mesh, mesh = standin(shape, names), AbstractMesh(names, shape)
        for path, spec in port:
            r = ref[_unlayered(path)]
            stacked = len(r.shape) == len(spec.shape) + 1
            assert tuple(r.shape[int(stacked):]) == tuple(spec.shape)
            assert tuple(r.logical[int(stacked):]) == tuple(spec.logical)
            want = tuple(r_sharding.DEFAULT_RULES.mesh_axes(r.logical, r_mesh, r.shape))
            got = DEFAULT_RULES.mesh_axes(spec.logical, mesh, spec.shape)
            if stacked:
                assert want[0] is None
                want = want[1:]
            assert got == want, (arch, which, shape, path)


def test_rules_entry_for_entry():
    assert DEFAULT_RULES.rules == r_sharding.DEFAULT_RULES.rules


def test_axes_absent_from_the_mesh_are_dropped():
    mesh = AbstractMesh(("data", "model"), (2, 2))
    assert DEFAULT_RULES.mesh_axes(("batch", "stage"), mesh) == ("data", None)  # no 'pod', no 'pipe'
    assert DEFAULT_RULES.mesh_axes(("batch",), AbstractMesh(("pod", "data"), (2, 2))) == (("pod", "data"),)


def test_one_mesh_axis_is_never_used_twice():
    mesh = AbstractMesh(("data", "model"), (2, 2))
    assert DEFAULT_RULES.mesh_axes(("heads", "head_dim"), mesh, (8, 64)) == ("model", None)
    assert DEFAULT_RULES.mesh_axes(("batch", "attn_seq", "heads"), mesh, (4, 16, 8)) == ("data", "model", None)


def test_non_dividing_dimension_falls_through():
    mesh = AbstractMesh(("data", "model"), (1, 4))
    # RecurrentGemma's 10 heads on a 4-way model axis: head_dim takes it
    assert DEFAULT_RULES.mesh_axes(("embed", "heads", "head_dim"), mesh, (2560, 10, 256)) == (None, None, "model")
    # batch 4 on 16 x 16: replicated
    big = AbstractMesh(("data", "model"), (16, 16))
    assert DEFAULT_RULES.mesh_axes(("batch", "attn_seq"), big, (4, 4096)) == (None, "model")
    r = r_sharding.DEFAULT_RULES.mesh_axes(("batch", "attn_seq"), standin((16, 16), ("data", "model")), (4, 4096))
    assert tuple(r) == (None, "model")


def test_placements_follow_the_spec():
    from torch.distributed.tensor import Replicate, Shard

    mesh = AbstractMesh(("pod", "data", "model"), (2, 2, 2))
    assert NamedSharding(mesh, (("pod", "data"), None, "model")).placements() == (Shard(0), Shard(0), Shard(2))
    assert NamedSharding(mesh, (None, None)).placements() == (Replicate(),) * 3


def test_nested_axis_rules_restore_the_outer():
    inner = LogicalAxisRules([("batch", "model")])  # a plain axis, not a tuple
    m1, m2 = AbstractMesh(("data", "model"), (2, 2)), AbstractMesh(("model",), (4,))
    assert current_rules() is DEFAULT_RULES and sharding.current_mesh() is None
    with axis_rules(DEFAULT_RULES, m1):
        assert logical_spec(("batch",), shape=(4,)) == ("data",)
        with axis_rules(inner, m2):
            assert current_rules() is inner and sharding.current_mesh() is m2
            assert logical_spec(("batch",), shape=(4,)) == ("model",)
        assert current_rules() is DEFAULT_RULES and sharding.current_mesh() is m1
    assert sharding.current_mesh() is None


def test_with_logical_constraint_does_nothing_without_a_mesh():
    x = torch.arange(12.0).reshape(3, 4)
    assert with_logical_constraint(x, ("batch", "embed")) is x
    with axis_rules(DEFAULT_RULES, AbstractMesh(("data", "model"), (2, 2))):
        assert with_logical_constraint(x, ("batch", "embed")) is x  # a plain tensor stays as it is
