"""The port's forest inference against the JAX reference's kernel.

The reference `repro.kernels.ops.rf_predict` runs its Pallas body in
interpret mode on the CPU; the port's `ops.rf_predict` takes its plain
version for CPU tensors. Both add the leaf values tree by tree in f32
and multiply by the f32 reciprocal of T, so the outputs are compared
bit for bit (`assert_array_equal`), not within a tolerance.

The reference is imported by a fixture, so the card-only case (marked
`cuda`) runs where jax is not installed:
``python -m pytest -q -m cuda tests/test_torch_rf_predict.py``.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.core.forest import RandomForest
from repro_torch.kernels import ops, rf_predict
from repro_torch.kernels.ref import rf_predict_ref
from repro_torch.wan.dataset import generate_dataset

SHAPES = [(8, 5), (30, 10), (100, 10)]
NS = [1, 57, 300]


@pytest.fixture(scope="module")
def data():
    """A small §5.1-style training set (a few hundred pair rows)."""
    return generate_dataset(n_samples=8, seed=3)


@pytest.fixture(scope="module")
def forests(data):
    """Forests fitted once per (T, depth) (the fit is the reference's
    to the bit; see test_torch_wan)."""
    X, y = data
    return {(T, d): RandomForest(n_trees=T, depth=d, seed=T).fit(X, y)
            for T, d in SHAPES}


@pytest.fixture(scope="module")
def ref():
    """The JAX reference: jnp, its kernel wrappers and its forest."""
    import jax.numpy as jnp

    from repro.core.forest import RandomForest as RefForest
    from repro.kernels import ops as ref_ops
    return types.SimpleNamespace(jnp=jnp, ops=ref_ops, Forest=RefForest)


def _queries(data, n, seed):
    X, _ = data
    rng = np.random.default_rng(seed)
    rows = X[rng.integers(0, len(X), n)]
    # jitter so queries also fall between the training thresholds
    return (rows * rng.uniform(0.9, 1.1, rows.shape)).astype(np.float32)


def _port(rf):
    return RandomForest.from_packed(
        *rf.packed(), rf.depth, n_trees=rf.n_trees, min_leaf=rf.min_leaf,
        feature_frac=rf.feature_frac, seed=rf.seed)


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"T{s[0]}d{s[1]}")
def test_rf_predict_bit_equal_reference(ref, data, forests, shape, n):
    rf = forests[shape]
    Xq = _queries(data, n, seed=n)
    want = np.asarray(ref.ops.rf_predict(
        *(ref.jnp.asarray(a) for a in (*rf.packed(), Xq)), depth=rf.depth))
    got = ops.rf_predict(*(torch.from_numpy(a) for a in rf.packed()),
                         torch.from_numpy(Xq), depth=rf.depth)
    assert got.dtype == torch.float32 and got.shape == (n,)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", [(8, 5), (5, 10)],
                         ids=lambda s: f"T{s[0]}d{s[1]}")
def test_from_packed_round_trips(ref, data, shape):
    """The JAX package's fitted forest, carried across, predicts the
    same on both sides."""
    X, y = data
    rf = ref.Forest(n_trees=shape[0], depth=shape[1], seed=4).fit(X, y)
    port = _port(rf)
    for a, b in zip(port.packed(), rf.packed()):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert (port.n_trees, port.depth, port.min_leaf, port.feature_frac,
            port.seed) == (rf.n_trees, rf.depth, rf.min_leaf,
                           rf.feature_frac, rf.seed)
    Xq = _queries(data, 57, seed=1)
    np.testing.assert_array_equal(port.predict(Xq), rf.predict(Xq))
    got = ops.rf_predict(*(torch.from_numpy(a) for a in port.packed()),
                         torch.from_numpy(Xq), depth=port.depth)
    want = ref.ops.rf_predict(*(ref.jnp.asarray(a) for a in
                                (*rf.packed(), Xq)), depth=rf.depth)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_from_packed_rejects_incomplete_trees(forests):
    f, t, l = forests[(8, 5)].packed()
    with pytest.raises(ValueError, match="complete trees"):
        RandomForest.from_packed(f, t, l[:, :-1], 5)
    with pytest.raises(ValueError, match="complete trees"):
        RandomForest.from_packed(f, t, l, 4)


def test_reciprocal_multiply_not_divide():
    """At T=30 the reference's multiply by f32(1/30) and a divide by 30
    round differently; the port follows the multiply."""
    rng = np.random.default_rng(0)
    sums = rng.uniform(100, 60000, 4000).astype(np.float32)
    inv = rf_predict.inv_trees(30)
    assert inv.dtype == np.float32
    assert np.any(sums * inv != sums / np.float32(30))


def test_out_of_range_feature_reads_zero(ref):
    """A feature index past the row reads 0 in the plain version, as
    the reference kernel's one-hot select does."""
    feat = torch.tensor([[9]], dtype=torch.int32)
    thr = torch.tensor([[-0.5]], dtype=torch.float32)
    leaf = torch.tensor([[1.0, 2.0]], dtype=torch.float32)
    X = torch.ones((3, 6), dtype=torch.float32)
    got = rf_predict_ref(feat, thr, leaf, X, 1)
    want = ref.ops.rf_predict(*(ref.jnp.asarray(a.numpy())
                                for a in (feat, thr, leaf, X)), depth=1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), [2.0, 2.0, 2.0])


@pytest.fixture
def card():
    """The CUDA device; skips the test where there is none (decided at
    setup, so every worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 191, 4099])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"T{s[0]}d{s[1]}")
def test_rf_kernel_bit_equal_plain_on_card(card, data, forests, shape, n):
    rf = forests[shape]
    packed = [torch.from_numpy(a).to(card) for a in rf.packed()]
    Xq = torch.from_numpy(_queries(data, n, seed=n)).to(card)
    before = ops.rf_predict.launches
    got = ops.rf_predict(*packed, Xq, depth=rf.depth)
    torch.cuda.synchronize()
    assert ops.rf_predict.launches == before + 1
    want = rf_predict_ref(*packed, Xq, rf.depth)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
