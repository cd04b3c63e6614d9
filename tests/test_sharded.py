"""Multi-device sharded paths == single-device results, bit for bit.

Runs on the 8-device virtual CPU mesh (see conftest.py), validating the
integer-psum design: N-shard statistics, k-means steps, and quantization
are identical to the host oracles.
"""

import jax
import numpy as np
import pytest

from qvz_tpu.parallel import mesh as mesh_mod
from qvz_tpu.parallel import sharded
from qvz_tpu.spec import stats as np_stats
from qvz_tpu.spec.pipeline import load_quality_file


@pytest.fixture(scope="module")
def small(golden_dir):
    return load_quality_file(golden_dir / "small.in")


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) >= 8, "conftest must force 8 CPU devices"
    return mesh_mod.make_mesh(8)


def test_sharded_stats_match(mesh8, small):
    rng = np.random.default_rng(7)
    clusters = rng.integers(0, 3, size=len(small)).astype(np.uint8)
    c0_ref, cc_ref = np_stats.conditional_counts(small, clusters, 3)
    c0, cc = sharded.sharded_conditional_counts(mesh8, small, clusters, 3)
    np.testing.assert_array_equal(c0, c0_ref)
    np.testing.assert_array_equal(cc, cc_ref)


def test_sharded_stats_unpadded_vs_padded(mesh8, small):
    # 1000 lines % 8 == 0, so also test a ragged shard count.
    ragged = small[:997]
    c0_ref, cc_ref = np_stats.conditional_counts(
        ragged, np.zeros(997, np.uint8), 1)
    c0, cc = sharded.sharded_conditional_counts(mesh8, ragged, None, 1)
    np.testing.assert_array_equal(c0, c0_ref)
    np.testing.assert_array_equal(cc, cc_ref)


def test_sharded_kmeans_step_matches(mesh8, small):
    import jax.numpy as jnp
    from qvz_tpu.spec.kmeans import seed_centroids, kmeans_assign

    means = seed_centroids(small, 3)
    dpad, valid = sharded.pad_reads(small, 8)
    fn = sharded.make_sharded_kmeans_step(mesh8, 3)
    assign, new_means, moved = fn(
        jnp.asarray(dpad.T, dtype=jnp.int32),
        jnp.asarray(means, dtype=jnp.int32),
        jnp.asarray(valid))
    assign = np.asarray(assign)[: len(small)]

    ref_assign = kmeans_assign(small.astype(np.int32), means)
    np.testing.assert_array_equal(assign, ref_assign)
    # means: integer-division update
    counts = np.bincount(ref_assign, minlength=3)
    acc = np.zeros((3, small.shape[1]), dtype=np.int64)
    np.add.at(acc, ref_assign, small.astype(np.int64))
    ref_means = acc // np.maximum(counts, 1)[:, None]
    np.testing.assert_array_equal(np.asarray(new_means), ref_means)


def test_sharded_quantize_matches(mesh8, small):
    import jax.numpy as jnp
    from qvz_tpu.constants import DISTORTION_MSE, MODE_RATIO
    from qvz_tpu.native import runtime as rt
    from qvz_tpu.ops import distortion as dm
    from qvz_tpu.ops.well import WellState
    from qvz_tpu.spec import stats as sstats

    n, cols = small.shape
    clusters = np.zeros(n, dtype=np.uint8)
    counts0, cond = sstats.conditional_counts(small, clusters, 1)
    design = rt.Design(counts0, cond, MODE_RATIO, 0.5,
                       dm.make_matrix(DISTORTION_MSE))
    tables = design.tables()
    draws = rt.well_draws7(WellState.debug().state, n * cols).reshape(n, cols)
    m_ref, s_ref, r_ref = rt.quantize(tables, small, clusters, draws)

    dpad, valid = sharded.pad_reads(small, 8)
    drpad, _ = sharded.pad_reads(draws, 8)
    clpad, _ = sharded.pad_reads(clusters, 8)
    fn = sharded.make_sharded_quantize(mesh8, cols)
    mids, qs, qv = fn(
        jnp.asarray(dpad.T, dtype=jnp.int32),
        jnp.asarray(drpad.T, dtype=jnp.int32),
        jnp.asarray(clpad.astype(np.int32) * cols),
        jnp.asarray(tables.ctxmap.reshape(-1), dtype=jnp.int32),
        jnp.asarray(tables.pair_base, dtype=jnp.int32),
        jnp.asarray(tables.qratio, dtype=jnp.int32),
        jnp.asarray(tables.qv_map.reshape(-1), dtype=jnp.int32),
        jnp.asarray(tables.qs_map.reshape(-1), dtype=jnp.int32))
    np.testing.assert_array_equal(np.asarray(mids).T[:n], m_ref)
    np.testing.assert_array_equal(np.asarray(qs).T[:n], s_ref)
    np.testing.assert_array_equal(np.asarray(qv).T[:n], r_ref)


def test_mesh_encode_container_identical_to_host(mesh8):
    """Distributed determinism: the full pipeline with an 8-device mesh
    produces a byte-identical container to the host-only pipeline."""
    import numpy as np
    from qvz_tpu.constants import DISTORTION_MSE
    from qvz_tpu.ops.distortion import make_matrix
    from qvz_tpu.ops.well import WellState
    from qvz_tpu.pipeline import encode as enc_mod

    rng = np.random.default_rng(11)
    start = rng.integers(20, 45, size=(777, 1))
    steps = rng.integers(-3, 4, size=(777, 23))
    data = np.clip(np.concatenate([start, steps], 1).cumsum(1), 0,
                   71).astype(np.uint8)
    dist = make_matrix(DISTORTION_MSE)
    kw = dict(n_clusters=3, ratio=0.5, want_recon=False)
    host = enc_mod.encode(data, dist, well_state=WellState.debug(),
                          use_jax=False, **kw)
    meshy = enc_mod.encode(data, dist, well_state=WellState.debug(),
                           mesh=mesh8, **kw)
    assert host.compressed == meshy.compressed

    sharded_out = enc_mod.encode(data, dist, well_state=WellState.debug(),
                                 mesh=mesh8, shards=4, **kw)
    from qvz_tpu.pipeline import decode as dec_mod
    assert np.array_equal(dec_mod.decode(host.compressed),
                          dec_mod.decode(sharded_out.compressed))


def test_device_quantize_production_path_byte_equal(mesh8):
    """The device-quantization production path (accelerator quantize scan
    + host entropy coding from precomputed streams) must emit containers
    byte-identical to the host fused path, for both the plain-JAX and
    the mesh variants, across cluster counts."""
    import numpy as np
    from qvz_tpu.constants import DISTORTION_MSE
    from qvz_tpu.ops.distortion import make_matrix
    from qvz_tpu.ops.well import WellState
    from qvz_tpu.pipeline import decode as dec_mod
    from qvz_tpu.pipeline import encode as enc_mod

    rng = np.random.default_rng(21)
    start = rng.integers(20, 45, size=(3000, 1))
    steps = rng.integers(-3, 4, size=(3000, 31))
    data = np.clip(np.concatenate([start, steps], 1).cumsum(1), 0,
                   71).astype(np.uint8)
    dist = make_matrix(DISTORTION_MSE)
    for n_clusters in (1, 3):
        kw = dict(n_clusters=n_clusters, ratio=0.5, want_recon=True,
                  well_state=WellState.debug(), shards=4)
        host = enc_mod.encode(data, dist, use_jax=False, **kw)
        dev = enc_mod.encode(data, dist, use_jax=True, **kw)
        meshy = enc_mod.encode(data, dist, mesh=mesh8, **kw)
        assert host.compressed == dev.compressed
        assert host.compressed == meshy.compressed
        assert np.array_equal(host.reconstructed, dev.reconstructed)
        assert "quantize" in dev.stats.device_seconds
        assert abs(host.stats.distortion - dev.stats.distortion) < 1e-9
        out = dec_mod.decode(dev.compressed)
        assert np.array_equal(out[:, :data.shape[1]],
                              host.reconstructed + 33)


def test_mesh_device_coder_byte_equal(mesh8, monkeypatch):
    """The device CODER composes with a mesh (round-4
    feature): quantize shards over reads, the fused coder
    scan shard_maps over the LANE axis (independent adaptive streams,
    no collectives), and the container is byte-identical to the host
    fused path. Uneven shard plan (13 shards over 6007 lines) + lane
    padding (13 -> 64 lanes on the 8-device mesh) engage the wave /
    padding logic. Reference scope: the whole coding loop
    qv_compressor.c:48-143 as a multi-chip computation."""
    from qvz_tpu.constants import DISTORTION_MSE
    from qvz_tpu.ops.distortion import make_matrix
    from qvz_tpu.ops.well import WellState
    from qvz_tpu.pipeline import decode as dec_mod
    from qvz_tpu.pipeline import encode as enc_mod

    rng = np.random.default_rng(7)
    n, cols = 6007, 33
    start = rng.integers(20, 45, size=(n, 1))
    steps = rng.integers(-2, 3, size=(n, cols - 1))
    data = np.clip(np.concatenate([start, steps], 1).cumsum(1), 0,
                   71).astype(np.uint8)
    dist = make_matrix(DISTORTION_MSE)
    kw = dict(n_clusters=3, ratio=0.5, want_recon=True, shards=13,
              well_state=WellState.debug())
    host = enc_mod.encode(data, dist, use_jax=False, **kw)
    meshy = enc_mod.encode(data, dist, mesh=mesh8, use_jax=True, **kw)
    assert host.compressed == meshy.compressed
    assert "device_code" in meshy.stats.device_seconds
    out = dec_mod.decode(meshy.compressed)
    assert np.array_equal(out[:, :cols] - 33, host.reconstructed)


def test_mesh_device_coder_unprimed_two_clusters(mesh8):
    """The mesh lane coder with a cluster-id segment and no priming
    (every lane starts from the initial bank): per-device lane subsets,
    byte-identical containers, no fallback lanes."""
    from qvz_tpu.constants import DISTORTION_MSE
    from qvz_tpu.ops.distortion import make_matrix
    from qvz_tpu.ops.well import WellState
    from qvz_tpu.pipeline import encode as enc_mod

    rng = np.random.default_rng(11)
    n, cols = 2003, 21
    start = rng.integers(20, 45, size=(n, 1))
    steps = rng.integers(-2, 3, size=(n, cols - 1))
    data = np.clip(np.concatenate([start, steps], 1).cumsum(1), 0,
                   71).astype(np.uint8)
    dist = make_matrix(DISTORTION_MSE)
    kw = dict(n_clusters=2, ratio=0.5, want_recon=False, shards=9,
              prime=False, well_state=WellState.debug())
    host = enc_mod.encode(data, dist, use_jax=False, **kw)
    meshy = enc_mod.encode(data, dist, mesh=mesh8, use_jax=True, **kw)
    assert host.compressed == meshy.compressed
    assert meshy.stats.coder_fallback_lanes == 0
