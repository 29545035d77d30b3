"""Member-batched storages of the port (``core/storage.py``,
``ensemble/batch.py``): the mirror of ``tests/test_storage_batch.py``.

The reference pads the trailing dims to the TPU's (8, 128) tile; the port
has no such padding.  What the reference's properties protect holds for the
port's own layout: the member axis ``N`` is leading and never folded into a
field's layout; ``default_origin`` keeps its meaning; member views are
copy-free; and every member of a ``cuda``-backend batch is in the card
layout (K slowest, then I, then J with stride 1: ``storage.is_card_layout``),
as a one-member ``cuda`` storage is.  Shapes, axes and origins equal the
reference's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch", reason="the torch port's tests need PyTorch")
pytest.importorskip("hypothesis", reason="property tests need the optional 'hypothesis' dependency")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.core import storage as r_storage  # noqa: E402
from repro.ensemble import batch as r_batch  # noqa: E402
from repro_torch.core import storage  # noqa: E402
from repro_torch.ensemble import batch  # noqa: E402

BACKENDS = ("numpy", "torch", "cuda")

_members = st.integers(1, 9)
_dim = st.integers(1, 40)
_shape3 = st.tuples(_dim, _dim, st.integers(1, 17))
_halo = st.integers(0, 3)


def _dev(backend):
    return None if backend == "numpy" else "cpu"


def _shares(a, b) -> bool:
    """Whether two storages' data overlap in memory."""
    if isinstance(a, np.ndarray):
        return np.shares_memory(a, b)
    return a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()


@settings(max_examples=25, deadline=None)
@given(members=_members, shape=_shape3)
def test_member_axis_is_leading_and_keeps_the_layout(members, shape):
    """The member axis is leading and never folded into a field's layout: a
    cuda batch's members are each in the card layout, the other backends'
    each in C order, as the one-member allocation."""
    ref = r_batch.zeros(members, shape, backend="numpy")
    for backend in BACKENDS:
        single = storage.zeros(shape, backend=backend, device=_dev(backend))
        batched = batch.zeros(members, shape, backend=backend, device=_dev(backend))
        assert batched.shape == ref.shape == (members,) + shape
        assert batched.axes == ref.axes == ("N", "I", "J", "K")
        data = batched.data
        if backend == "cuda":
            assert storage.is_card_layout(single.data) and storage.is_card_layout(data)
            assert data.stride(0) == int(np.prod(shape))  # members outermost, contiguous
        elif backend == "torch":
            assert data.is_contiguous()
        for m in range(members):
            view = batched.member(m).data
            assert tuple(view.shape) == shape
            if backend == "cuda":
                assert storage.is_card_layout(view)
                assert view.stride() == single.data.stride()


@settings(max_examples=25, deadline=None)
@given(members=_members, shape=_shape3, h=_halo)
def test_member_axis_preserves_default_origin(members, shape, h):
    ni, nj, nk = shape
    r_single = r_storage.storage_for_domain((ni, nj, nk), (h, h, 0), backend="numpy")
    r_batched = r_storage.storage_for_domain((ni, nj, nk), (h, h, 0), backend="numpy", members=members)
    for backend in BACKENDS:
        single = storage.storage_for_domain((ni, nj, nk), (h, h, 0), backend=backend, device=_dev(backend))
        batched = storage.storage_for_domain((ni, nj, nk), (h, h, 0), backend=backend, members=members,
                                             device=_dev(backend))
        assert (single.axes, single.default_origin, single.shape) == (
            r_single.axes, r_single.default_origin, r_single.shape)
        assert (batched.axes, batched.default_origin, batched.shape) == (
            r_batched.axes, r_batched.default_origin, r_batched.shape)
        for m in range(members):
            view = batched.member(m)
            assert view.axes == single.axes
            assert view.default_origin == single.default_origin
            assert view.shape == single.shape


@settings(max_examples=25, deadline=None)
@given(members=_members, shape=_shape3)
def test_batched_member_views_are_copy_free(members, shape):
    for backend in BACKENDS:
        batched = batch.zeros(members, shape, backend=backend, device=_dev(backend))
        if backend == "numpy":
            arr = np.asarray(batched)
            assert arr.shape == (members,) + shape and np.shares_memory(arr, batched.data)
        # member views share memory: writes through a view land in the batch
        if members > 1:
            view = batched.member(1)
            assert _shares(view.data, batched.data)
            view[0, 0, 0] = 42.0
            out = batched.to_numpy()
            assert out[1, 0, 0, 0] == 42.0 and out[0, 0, 0, 0] == 0.0


@settings(max_examples=25, deadline=None)
@given(shape=_shape3)
def test_write_read_roundtrip(shape):
    """Writes through a storage read back exactly, whatever its layout."""
    data = np.random.default_rng(0).normal(size=shape)
    for backend in BACKENDS:
        s = storage.zeros(shape, backend=backend, device=_dev(backend))
        s[...] = torch.from_numpy(data) if backend != "numpy" else data
        np.testing.assert_array_equal(s.to_numpy(), data)
        np.testing.assert_array_equal(storage.from_array(data, backend=backend, device=_dev(backend)).to_numpy(),
                                      data)


@settings(max_examples=15, deadline=None)
@given(members=_members, nk=st.integers(1, 300))
def test_k_only_batched_field_is_members_by_levels(members, nk):
    """A batched (N, K) field is (members, nk), unpadded, in every backend:
    the card layout is for (I, J, K) fields."""
    for backend in BACKENDS:
        batched = batch.zeros(members, (nk,), axes=("K",), backend=backend, device=_dev(backend))
        assert batched.shape == (members, nk) and batched.axes == ("N", "K")
        if backend != "numpy":
            assert batched.data.is_contiguous()


def test_card_layout_helper_edges():
    t = storage.card_tensor((3, 5, 7), torch.float64, "cpu")
    assert t.shape == (3, 5, 7) and t.stride() == (5, 1, 15)  # K slowest, then I, then J
    b = storage.card_tensor((4, 3, 5, 7), torch.float64, "cpu")
    assert b.stride() == (105, 5, 1, 15)  # members outermost
    assert storage.is_card_layout(t) and storage.is_card_layout(b) and storage.is_card_layout(b[2])
    assert not storage.is_card_layout(torch.zeros(3, 5, 7, dtype=torch.float64))
    assert not storage.is_card_layout(torch.zeros(5, 7, dtype=torch.float64))
    assert not storage.is_card_layout(torch.zeros(7, dtype=torch.float64))


def test_torch_backend_allocates_logical_c_order():
    """The torch backend holds C order, the logical allocation (the
    reference's jax backend leaves layout to XLA); the cuda backend the card
    layout."""
    s = storage.zeros((5, 6, 7), backend="torch", device="cpu")
    assert s.shape == (5, 6, 7) and s.data.is_contiguous()
    c = storage.zeros((5, 6, 7), backend="cuda", device="cpu")
    assert c.shape == (5, 6, 7) and storage.is_card_layout(c.data)
