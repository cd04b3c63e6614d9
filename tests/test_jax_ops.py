"""Device kernels (JAX) vs host oracles: exact integer equality."""

import numpy as np
import pytest

from qvz_tpu.constants import DISTORTION_MSE, MODE_RATIO
from qvz_tpu.ops import distortion as dm
from qvz_tpu.spec import kmeans as np_kmeans
from qvz_tpu.spec import stats as np_stats
from qvz_tpu.spec.pipeline import load_quality_file


@pytest.fixture(scope="module")
def small(golden_dir):
    return load_quality_file(golden_dir / "small.in")


def test_stats_histograms_match(small):
    from qvz_tpu.ops import stats as jx_stats
    rng = np.random.default_rng(0)
    clusters = rng.integers(0, 3, size=len(small)).astype(np.uint8)
    c0_ref, cc_ref = np_stats.conditional_counts(small, clusters, 3)
    c0, cc = jx_stats.conditional_counts(small, clusters, 3)
    np.testing.assert_array_equal(c0, c0_ref)
    np.testing.assert_array_equal(cc, cc_ref)


def test_stats_chunked_accumulation(small):
    from qvz_tpu.ops import stats as jx_stats
    old = jx_stats._CHUNK
    jx_stats._CHUNK = 257  # force many chunks
    try:
        c0_ref, cc_ref = np_stats.conditional_counts(
            small, np.zeros(len(small), np.uint8), 1)
        c0, cc = jx_stats.conditional_counts(small, None, 1)
        np.testing.assert_array_equal(c0, c0_ref)
        np.testing.assert_array_equal(cc, cc_ref)
    finally:
        jx_stats._CHUNK = old


def test_kmeans_matches_numpy(small):
    from qvz_tpu.ops import kmeans as jx_kmeans
    a_ref, m_ref, it_ref = np_kmeans.kmeans_cluster(small, 3, 4.0)
    a, m, it = jx_kmeans.kmeans_cluster(small, 3, 4.0)
    assert it == it_ref
    np.testing.assert_array_equal(a, a_ref)
    np.testing.assert_array_equal(m, m_ref)


def test_quantize_matches_native(small):
    from qvz_tpu.native import runtime as rt
    from qvz_tpu.ops import quantize as jx_quant
    from qvz_tpu.ops import stats as jx_stats
    from qvz_tpu.ops.well import WellState

    rng = np.random.default_rng(1)
    clusters = rng.integers(0, 2, size=len(small)).astype(np.uint8)
    counts0, cond = jx_stats.conditional_counts(small, clusters, 2)
    design = rt.Design(counts0, cond, MODE_RATIO, 0.5,
                       dm.make_matrix(DISTORTION_MSE))
    tables = design.tables()
    n, cols = small.shape
    draws = rt.well_draws7(WellState.debug().state, n * cols)
    draws = draws.reshape(n, cols)

    m_ref, s_ref, r_ref = rt.quantize(tables, small, clusters, draws)
    m, s, r = jx_quant.quantize(tables, small, clusters, draws)
    np.testing.assert_array_equal(m, m_ref)
    np.testing.assert_array_equal(s, s_ref)
    np.testing.assert_array_equal(r, r_ref)


def test_full_pipeline_jax_bit_exact(golden_dir, small):
    from qvz_tpu.pipeline import encode as enc_mod
    out = enc_mod.encode(small, dm.make_matrix(DISTORTION_MSE),
                         n_clusters=3, mode=MODE_RATIO, ratio=0.5,
                         use_jax=True)
    golden = (golden_dir / "c3_f05.q").read_bytes()
    assert out.compressed == golden


def test_quantize_t_bit_identical():
    """The column-major device quantize (quantize_t) must match the host
    exactly, with one cluster and with three."""
    from qvz_tpu.native import runtime as rt
    from qvz_tpu.ops import quantize as q
    from qvz_tpu.ops.distortion import make_matrix
    from qvz_tpu.ops.well import WellState

    rng = np.random.default_rng(13)
    n, cols = 3000, 32
    start = rng.integers(20, 45, size=(n, 1))
    steps = rng.integers(-3, 4, size=(n, cols - 1))
    data = np.clip(np.concatenate([start, steps], 1).cumsum(1), 0,
                   71).astype(np.uint8)
    for k in (1, 3):
        cl = (np.arange(n) % k).astype(np.uint8) if k > 1 else None
        c0, cond = rt.stats_host(data, cl, k)
        d = rt.Design(c0, cond, MODE_RATIO, 0.5,
                      make_matrix(DISTORTION_MSE))
        t = d.tables()
        sw = np.asarray(WellState.debug().state, dtype=np.uint32)
        draws = rt.well_draws7(sw, n * cols).reshape(n, cols)
        m_ref, s_ref, r_ref = rt.quantize(t, data, cl, draws,
                                          want_recon=True)
        mt, st, qt = q.quantize_t(t, data, cl, draws)
        assert np.array_equal(mt.T, m_ref)
        assert np.array_equal(st.T, s_ref)
        assert np.array_equal(qt.T, r_ref)
