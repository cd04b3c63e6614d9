"""The device phases' XLA forms against plain references, element-exact.

Every device phase is exact integer arithmetic (int32 distances and
scatter-add counts, integer gathers, u32 coder state), so every
comparison here has zero tolerance — on the CPU backend here, and on the
card in chip_smoke.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from qvz_tpu.constants import DISTORTION_MSE, MODE_RATIO
from qvz_tpu.native import runtime as rt
from qvz_tpu.ops.distortion import make_matrix
from qvz_tpu.ops.well import WellState
from qvz_tpu.spec import stats as np_stats


def oracle_step(data, means, K):
    d = data.astype(np.int64)
    m = means.astype(np.int64)
    dist = ((d[:, None, :] - m[None]) ** 2).sum(-1)
    assign = dist.argmin(1)
    sums = np.zeros((K, data.shape[1]), dtype=np.int64)
    np.add.at(sums, assign, d)
    counts = np.bincount(assign, minlength=K)
    return assign, sums, counts


@pytest.mark.parametrize("n,cols,K", [(700, 36, 3), (1500, 100, 5),
                                      (512, 17, 2)])
def test_kmeans_step_matches_oracle(n, cols, K):
    from qvz_tpu.ops.kmeans import _kmeans_step

    rng = np.random.default_rng(n)
    data = rng.integers(0, 72, size=(n, cols)).astype(np.uint8)
    means = rng.integers(0, 72, size=(K, cols)).astype(np.int32)
    a, m, _ = _kmeans_step(jnp.asarray(data), jnp.asarray(means), K)
    ar, sr, cr = oracle_step(data, means, K)
    assert np.array_equal(np.asarray(a), ar)
    assert np.array_equal(np.asarray(m), sr // np.maximum(cr, 1)[:, None])


def test_kmeans_step_ties_break_low():
    """Identical centroids: every read must pick index 0 (the
    reference's strict-< first minimum, cluster.c:158-163)."""
    from qvz_tpu.ops.kmeans import _kmeans_step

    data = np.full((512, 8), 30, dtype=np.uint8)
    means = np.full((2, 8), 10, dtype=np.int32)
    a, m, _ = _kmeans_step(jnp.asarray(data), jnp.asarray(means), 2)
    assert np.all(np.asarray(a) == 0)
    assert np.array_equal(np.asarray(m), [[30] * 8, [0] * 8])


@pytest.mark.parametrize("n", [2001, 3703, 3708])
def test_first_min_assign_ties_and_counts(n):
    """Exact distances and lowest-index ties at read counts where the
    former matmul form went wrong on the card; centroids 1 and 2 are
    equidistant from every read (they differ by +-1 in one column
    around a constant value)."""
    from qvz_tpu.ops.kmeans import first_min_assign
    from qvz_tpu.spec.kmeans import kmeans_assign

    rng = np.random.default_rng(n)
    data = rng.integers(0, 72, size=(n, 101)).astype(np.int32)
    data[:, 50] = 30
    means = data[[5, 77, 77]].copy()
    means[1, 50], means[2, 50] = 29, 31
    got = np.asarray(first_min_assign(jnp.asarray(data),
                                      jnp.asarray(means)))
    assert np.array_equal(got, kmeans_assign(data, means))
    assert not (got == 2).any()


def test_sharded_kmeans_padded_rows_excluded():
    """The mesh form's shard-local step: rows padded onto the reads
    axis (valid = False) contribute to no sum or count."""
    from qvz_tpu.parallel.sharded import _local_kmeans_assign, pad_reads

    n, cols, K = 100, 12, 2
    rng = np.random.default_rng(1)
    data = rng.integers(0, 72, size=(n, cols)).astype(np.uint8)
    means = rng.integers(0, 72, size=(K, cols)).astype(np.int32)
    dpad, valid = pad_reads(data, 512)
    a, c, s = _local_kmeans_assign(
        jnp.asarray(dpad.T, dtype=jnp.int32), jnp.asarray(means),
        jnp.asarray(valid), K)
    ar, sr, cr = oracle_step(data, means, K)
    assert int(np.asarray(c).sum()) == n
    assert np.array_equal(np.asarray(a)[:n], ar)
    assert np.array_equal(np.asarray(s), sr)
    assert np.array_equal(np.asarray(c), cr)


@pytest.mark.parametrize("n,cols,K", [(1100, 50, 3), (600, 100, 1),
                                      (2048, 33, 2)])
def test_hist_device_matches_oracle(n, cols, K):
    from qvz_tpu.ops.stats import _hist_device

    rng = np.random.default_rng(n + K)
    data = rng.integers(0, 72, size=(n, cols)).astype(np.uint8)
    cl = rng.integers(0, K, size=n).astype(np.uint8)
    c0, cond = _hist_device(jnp.asarray(data), jnp.asarray(cl), K)
    want = np.zeros((cols - 1, K * 72, 72), dtype=np.int64)
    want0 = np.zeros((K, 72), dtype=np.int64)
    for i in range(n):
        row = data[i].astype(np.int64)
        base = int(cl[i]) * 72
        np.add.at(want, (np.arange(cols - 1), base + row[:-1], row[1:]), 1)
        want0[cl[i], row[0]] += 1
    assert np.array_equal(np.asarray(cond), want)
    assert np.array_equal(np.asarray(c0), want0)


def _walk(rng, n, cols, lo=20, hi=45):
    start = rng.integers(lo, hi, size=(n, 1))
    steps = rng.integers(-3, 4, size=(n, max(cols - 1, 0)))
    return np.clip(np.concatenate([start, steps], 1).cumsum(1), 0,
                   71).astype(np.uint8)


def _tables(data, clusters, n_cl, ratio=0.5):
    if clusters is None:
        clusters = np.zeros(len(data), dtype=np.uint8)
    c0, cond = np_stats.conditional_counts(data, clusters, n_cl)
    return rt.Design(c0, cond, MODE_RATIO, ratio,
                     make_matrix(DISTORTION_MSE)).tables()


@pytest.mark.parametrize("W", [40, 384, 130])
def test_encode_lanes_matches_host_coder(W):
    """The lane coder at several lane counts (one ragged last lane):
    each lane's payload equals the host coder's for the same
    quantization decisions."""
    from qvz_tpu.ops import coder_device as cd

    rng = np.random.default_rng(W)
    L, cols = 64, 3
    n = W * L - 13
    data = _walk(rng, n, cols)
    tables = _tables(data, None, 1)
    md, qs, _, _ = rt.quantize_colmajor(
        tables, np.ascontiguousarray(data.T), None,
        WellState.debug().state)
    counts = [L] * (W - 1) + [L - 13]
    pays, flags = cd.encode_lanes(cd.LanePlan(tables, None), md, qs,
                                  counts, 0, None)
    assert not flags.any()
    for w in range(W):
        lo, hi = w * L, w * L + counts[w]
        assert pays[w] == rt.encode_precomputed_colmajor(
            tables, md[:, lo:hi], qs[:, lo:hi], None, hi - lo), w


def _quantize_both(data, clusters, tables, draws):
    from qvz_tpu.ops import quantize as q

    m, s, v, _ = q.quantize_t_device(tables, data, clusters, draws)
    mr, sr, rr = rt.quantize(tables, data, clusters, draws)
    return ((np.asarray(m).T, np.asarray(s).T, np.asarray(v).T),
            (mr, sr, rr))


def test_quantize_gather_matches_host_multicluster():
    """Multi-cluster tables and the column context recursion."""
    rng = np.random.default_rng(41)
    n, cols, n_cl = 3000, 24, 2
    data = _walk(rng, n, cols)
    clusters = (np.arange(n) % n_cl).astype(np.uint8)
    tables = _tables(data, clusters, n_cl)
    draws = rng.integers(0, 128, size=(n, cols)).astype(np.uint8)
    got, want = _quantize_both(data, clusters, tables, draws)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)


def test_quantize_device_resident_input():
    """The shared-upload path: a device-resident input (the encode's
    one h2d copy) gives the same outputs as a host array."""
    from qvz_tpu.ops import quantize as q

    rng = np.random.default_rng(5)
    n, cols = 2000, 12
    data = _walk(rng, n, cols)
    tables = _tables(data, None, 1)
    draws = rng.integers(0, 128, size=(n, cols)).astype(np.uint8)
    host = q.quantize_t_device(tables, data, None, draws)
    dev = q.quantize_t_device(tables, jnp.asarray(data), None, draws)
    for a, b in zip(host, dev):
        assert np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("ratio,cols,n_cl", [
    (0.0, 8, 1),    # card-1 quantizers everywhere
    (0.9, 8, 1),    # high-rate: large state cardinalities
    (0.5, 1, 1),    # single column (no context recursion at all)
    (0.85, 6, 3),   # multi-cluster high-rate
])
def test_quantize_gather_edge_geometries(ratio, cols, n_cl):
    rng = np.random.default_rng(int(ratio * 100) + cols)
    n = 1500
    data = _walk(rng, n, cols)
    clusters = (np.arange(n) % n_cl).astype(np.uint8)
    tables = _tables(data, clusters, n_cl, ratio)
    draws = rng.integers(0, 128, size=(n, cols)).astype(np.uint8)
    got, want = _quantize_both(data, clusters if n_cl > 1 else None,
                               tables, draws)
    for a, b in zip(got, want):
        assert np.array_equal(a, b), ratio


def test_quantize_gather_long_recursion():
    """A long column recursion (300 columns, two clusters)."""
    rng = np.random.default_rng(44)
    n, cols, n_cl = 800, 300, 2
    data = _walk(rng, n, cols)
    clusters = (np.arange(n) % n_cl).astype(np.uint8)
    tables = _tables(data, clusters, n_cl)
    draws = rng.integers(0, 128, size=(n, cols)).astype(np.uint8)
    got, want = _quantize_both(data, clusters, tables, draws)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)


def test_lanes_layout():
    """(cols, N) -> (cols, Wb, Lb) lane layout: lines from `base`, a
    ragged last lane, lane padding to a device multiple, zero fill."""
    from qvz_tpu.ops.coder_device import _lanes

    cols, base, W, L, Wb, Lb = 3, 5, 4, 6, 8, 256
    n = base + (W - 1) * L + 2
    x = np.arange(cols * n, dtype=np.uint32).reshape(cols, n)
    got = np.asarray(_lanes(jnp.asarray(x), W, L, Wb, Lb, base))
    assert got.shape == (cols, Wb, Lb)
    want = np.zeros((cols, Wb, Lb), dtype=np.int64)
    for w in range(W):
        seg = x[:, base + w * L: min(n, base + (w + 1) * L)]
        want[:, w, :seg.shape[1]] = seg
    assert np.array_equal(got, want)
