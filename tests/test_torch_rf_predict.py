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


def _rehearse(feat, thr, leaf, X, depth, warps):
    """The tile kernel's decomposition in numpy, step for step: tiles of
    32 samples (one per lane) in a zero-padded [32, (F+1)|1] row block;
    warp w of W walks trees w, w+W, ... ILP at a time from the packed
    8-byte nodes (a slot past the last tree walks slot 0's tree again
    and writes nothing); every walk writes vals[t][lane] (each exactly
    once, checked), and one warp adds them in tree order and multiplies
    by f32(1/T)."""
    T, n_int = feat.shape
    n, F = X.shape
    flat = rf_predict.pack_nodes(torch.from_numpy(feat), torch.from_numpy(
        thr)).numpy().reshape(-1, 2)
    stride = (F + 1) | 1
    inv = rf_predict.inv_trees(T)
    out = np.empty(n, np.float32)
    lanes = np.arange(32)
    for tile in range(-(-n // 32)):
        xs = np.zeros((32, stride), np.float32)
        rows = X[tile * 32:(tile + 1) * 32]
        xs[:len(rows), :F] = rows
        vals = np.full((T, 32), np.nan, np.float32)
        for warp in range(warps):
            for j0 in range(warp, T, rf_predict.ILP * warps):
                for i in range(rf_predict.ILP):
                    live = j0 + i * warps < T
                    t = j0 + i * warps if live else j0
                    node = np.zeros(32, np.int64)
                    for _ in range(depth):
                        nd = flat[t * n_int + node]
                        f = np.clip(nd[:, 0], 0, F)
                        go = xs[lanes, f] > nd[:, 1].view(np.float32)
                        node = 2 * node + 1 + go
                    if live:
                        assert np.isnan(vals[t]).all(), "tree twice"
                        vals[t] = leaf[t, node - n_int]
        assert not np.isnan(vals).any(), "a tree left out"
        acc = np.zeros(32, np.float32)
        for t in range(T):
            acc = acc + vals[t]
        out[tile * 32:(tile + 1) * 32] = (acc * inv)[:len(rows)]
    return out


@pytest.mark.parametrize("warps", [None, 1, 3, 8, 25],
                         ids=lambda w: "default" if w is None else f"W{w}")
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"T{s[0]}d{s[1]}")
def test_kernel_decomposition_bit_equal_reference(ref, data, forests, shape,
                                                  warps):
    """The tile kernel's split of trees over warps, ILP at a time, and
    its tree-order combine, rehearsed on the CPU, give the reference's
    interpret-mode kernel to the bit."""
    rf = forests[shape]
    n = 70                                    # two tiles and a ragged one
    Xq = _queries(data, n, seed=11)
    # a third of the trees' roots read a feature past the row (0)
    feat = rf.feat.copy()
    feat[:, 0] = np.where(np.arange(len(feat)) % 3 == 0, 9, feat[:, 0])
    if warps is None:
        warps = rf_predict.launch_shape(10 ** 5, len(feat), Xq.shape[1],
                                        sms=132).warps
    got = _rehearse(feat, rf.thr, rf.leaf, Xq, rf.depth, warps)
    want = np.asarray(ref.ops.rf_predict(
        *(ref.jnp.asarray(a) for a in (feat, rf.thr, rf.leaf, Xq)),
        depth=rf.depth))
    np.testing.assert_array_equal(got, want)


def test_pack_nodes_round_trips_bit_for_bit(forests):
    """The 8-byte node layout holds feat and the bits of thr (NaN, -0.0
    and subnormal thresholds included) and gives both back."""
    rf = forests[(30, 10)]
    thr = rf.thr.copy()
    thr[0, :4] = [np.nan, -0.0, np.float32(1e-45), -np.inf]
    feat, thr_t = torch.from_numpy(rf.feat), torch.from_numpy(thr)
    nodes = rf_predict.pack_nodes(feat, thr_t)
    assert nodes.dtype == torch.int32 and nodes.is_contiguous()
    assert tuple(nodes.shape) == (*rf.feat.shape, 2)
    # node k of tree t: feat then thr's bits, 8 bytes
    flat = nodes.numpy().reshape(-1)
    np.testing.assert_array_equal(flat[0::2], rf.feat.reshape(-1))
    np.testing.assert_array_equal(flat[1::2], thr.view(np.int32).reshape(-1))
    feat_back = nodes[..., 0].contiguous()
    thr_back = nodes[..., 1].contiguous().view(torch.float32)
    np.testing.assert_array_equal(feat_back.numpy(), rf.feat)
    np.testing.assert_array_equal(thr_back.numpy().view(np.int32),
                                  thr.view(np.int32))
    with pytest.raises(ValueError):
        rf_predict.pack_nodes(feat.float(), thr_t)
    got = ops.rf_predict(feat, thr_t, torch.from_numpy(rf.leaf),
                         torch.zeros((3, 6)), depth=rf.depth, nodes=nodes)
    want = ops.rf_predict(feat, thr_t, torch.from_numpy(rf.leaf),
                          torch.zeros((3, 6)), depth=rf.depth)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    with pytest.raises(ValueError, match="nodes must be int32"):
        ops.rf_predict(feat, thr_t, torch.from_numpy(rf.leaf),
                       torch.zeros((3, 6)), depth=rf.depth, nodes=nodes[:-1])


@pytest.mark.parametrize("n,T,want", [
    (1, 100, ("pair", 0)), (192, 100, ("pair", 0)), (1024, 8, ("pair", 0)),
    (1025, 100, ("tile", 25)), (3072, 100, ("tile", 25)),
    (3072, 8, ("tile", 2)), (4224, 100, ("tile", 25)),
    (4225, 100, ("tile", 13)), (8448, 100, ("tile", 13)),
    (8449, 100, ("tile", 8)), (14444, 100, ("tile", 8)),
    (14444, 30, ("tile", 8)), (14444, 8, ("tile", 2)),
    (14444, 200, ("tile", 8))])
def test_launch_shape(n, T, want):
    """The pair kernel up to PAIR_ROWS rows; the tile kernel beyond, in
    one round of ILP trees a warp while the tiles fit the SMs once, two
    while they fit twice, else BATCH_WARPS warps."""
    got = rf_predict.launch_shape(n, T, 6, sms=132)
    assert (got.kernel, got.warps) == want
    if got.kernel == "tile":
        assert rf_predict.tile_smem_bytes(T, 6) <= rf_predict.SMEM_LIMIT


def test_launch_shape_limits():
    """Leaf values or rows past a block's shared memory raise."""
    with pytest.raises(ValueError, match="shared memory"):
        rf_predict.launch_shape(14444, 2000, 6, sms=132)
    with pytest.raises(ValueError, match="pair-kernel block"):
        rf_predict.launch_shape(100, 8, 20000, sms=132)
    assert rf_predict.samples_per_block(100, 6) == 2
    assert rf_predict.samples_per_block(8, 6) == 32


@pytest.fixture
def card():
    """The CUDA device; skips the test where there is none (decided at
    setup, so every worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


CARD_SHAPES = SHAPES + [(30, 12)]
CARD_NS = [1, 31, 32, 33, 191, 192, 3072, 4099, 14444]


@pytest.fixture(scope="module")
def card_forests(data):
    X, y = data
    return {(T, d): RandomForest(n_trees=T, depth=d, seed=T).fit(X, y)
            for T, d in CARD_SHAPES}


@pytest.mark.cuda
@pytest.mark.parametrize("n", CARD_NS)
@pytest.mark.parametrize("shape", CARD_SHAPES,
                         ids=lambda s: f"T{s[0]}d{s[1]}")
def test_rf_kernel_bit_equal_plain_on_card(card, data, card_forests, shape,
                                           n):
    rf = card_forests[shape]
    packed = [torch.from_numpy(a).to(card) for a in rf.packed()]
    nodes = rf_predict.pack_nodes(packed[0], packed[1])
    Xq = torch.from_numpy(_queries(data, n, seed=n)).to(card)
    torch.cuda.synchronize()
    before = ops.rf_predict.launches
    got = ops.rf_predict(*packed, Xq, depth=rf.depth, nodes=nodes)
    torch.cuda.synchronize()
    assert ops.rf_predict.launches == before + 1
    want = rf_predict_ref(*packed, Xq, rf.depth)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


FORCED = [rf_predict.LaunchShape("pair"),
          rf_predict.LaunchShape("tile", 1),
          rf_predict.LaunchShape("tile", 3),
          rf_predict.LaunchShape("tile", 8),
          rf_predict.LaunchShape("tile", 25),
          rf_predict.LaunchShape("tile", 32)]
LOOP_ROWS = 14444        # 452 tiles: more than 25- or 32-warp blocks fit


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1000, LOOP_ROWS])
@pytest.mark.parametrize("cut", FORCED,
                         ids=lambda c: f"{c.kernel}{c.warps or ''}")
def test_rf_kernel_forced_shapes_on_card(card, data, card_forests, cut, n):
    """Each kernel at shapes the wrapper would not pick (the pair kernel
    at 1,000 and 14,444 rows; one warp; T not a multiple of the warps),
    and the tile kernel with every tile in flight or, at 25 and 32 warps
    on 14,444 rows, more tiles than blocks that can run at once, so each
    block of the persistent grid loops over tiles (the deferred sum and
    the rows copied a tile ahead)."""
    rf = card_forests[(100, 10)]
    packed = [torch.from_numpy(a).to(card) for a in rf.packed()]
    nodes = rf_predict.pack_nodes(packed[0], packed[1])
    Xq = torch.from_numpy(_queries(data, n, seed=5)).to(card)
    if cut.warps >= 25 and n == LOOP_ROWS:
        props = torch.cuda.get_device_properties(card)
        most = props.max_threads_per_multi_processor // (32 * cut.warps) \
            * props.multi_processor_count
        assert -(-n // rf_predict.TILE) > most, "the grid would not loop"
    want = rf_predict_ref(*packed, Xq, rf.depth)
    out = torch.full((n,), float("nan"), device=card)
    rf_predict.launch(nodes, packed[2], Xq, out, rf.depth, shape=cut)
    np.testing.assert_array_equal(out.cpu().numpy(), want.cpu().numpy())


@pytest.mark.cuda
def test_rf_kernel_forests_in_turn_on_card(card, data, card_forests):
    """A large forest, a small one, then the large one again at a shape
    it already ran: the kernel's shared-memory limit is not lowered by
    the small forest."""
    Xq = torch.from_numpy(_queries(data, 3000, seed=7)).to(card)
    cut = rf_predict.LaunchShape("tile", rf_predict.BATCH_WARPS)
    for shape in [(100, 10), (8, 5), (100, 10), (30, 12)]:
        rf = card_forests[shape]
        packed = [torch.from_numpy(a).to(card) for a in rf.packed()]
        nodes = rf_predict.pack_nodes(packed[0], packed[1])
        out = torch.full((3000,), float("nan"), device=card)
        rf_predict.launch(nodes, packed[2], Xq, out, rf.depth, shape=cut)
        want = rf_predict_ref(*packed, Xq, rf.depth)
        np.testing.assert_array_equal(out.cpu().numpy(), want.cpu().numpy())
