"""Sharded (multi-chip) pipeline steps via shard_map + integer psum.

All collective payloads are exact integers (histogram counts, centroid
accumulators), so N-device results are bit-identical to 1-device results
-- the multi-host determinism requirement of SURVEY.md section 2.

Padding: the reads axis is padded to a multiple of the mesh size with
masked-out rows (valid=0) that contribute nothing to any reduction.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from jax import shard_map

from qvz_tpu.constants import ALPHABET_SIZE
from qvz_tpu.ops.kmeans import first_min_assign
from qvz_tpu.ops.stats import cond_hist
from qvz_tpu.parallel.mesh import READS_AXIS, pad_to_multiple

A = ALPHABET_SIZE


def _local_hist(data_t, clusters, valid, n_clusters):
    """Shard-local histograms (ops/stats.cond_hist); padded rows
    (valid = False) count nowhere."""
    return cond_hist(data_t.T, clusters, n_clusters, valid)


def _local_kmeans_assign(data_t, means, valid, n_clusters):
    """Shard-local assignment + accumulators (exact integers)."""
    d = data_t.T.astype(jnp.int32)  # (n, cols)
    assign = first_min_assign(d, means)
    seg = jnp.where(valid, assign, n_clusters)
    counts = jax.ops.segment_sum(
        jnp.ones_like(assign), seg, num_segments=n_clusters + 1)[:-1]
    acc = jax.ops.segment_sum(d, seg, num_segments=n_clusters + 1)[:-1]
    return assign, counts, acc


def make_sharded_stats(mesh, n_clusters: int):
    """Returns fn(data_t (cols, Npad), clusters, valid) -> global counts."""

    def step(data_t, clusters, valid):
        c0, cond = _local_hist(data_t, clusters, valid, n_clusters)
        c0 = jax.lax.psum(c0, READS_AXIS)
        cond = jax.lax.psum(cond, READS_AXIS)
        return c0, cond

    fn = shard_map(
        step, mesh=mesh,
        in_specs=(P(None, READS_AXIS), P(READS_AXIS), P(READS_AXIS)),
        out_specs=(P(), P()),
    )
    return jax.jit(fn)


def make_sharded_kmeans_step(mesh, n_clusters: int):
    """Returns fn(data_t, means, valid) -> (assign, new_means, moved)."""

    def step(data_t, means, valid):
        assign, counts, acc = _local_kmeans_assign(
            data_t, means, valid, n_clusters)
        counts = jax.lax.psum(counts, READS_AXIS)
        acc = jax.lax.psum(acc, READS_AXIS)
        new_means = acc // jnp.maximum(counts, 1)[:, None]
        diff = (new_means - means).astype(jnp.float32)
        moved = jnp.max(jnp.sum(diff * diff, axis=1))
        return assign, new_means, moved

    fn = shard_map(
        step, mesh=mesh,
        in_specs=(P(None, READS_AXIS), P(), P(READS_AXIS)),
        out_specs=(P(READS_AXIS), P(), P()),
    )
    return jax.jit(fn)


def make_sharded_quantize(mesh, columns: int):
    """Returns fn(data_t, draws_t, cluster_base, *tables) -> per-symbol ids.

    Pure map over reads; no collectives. Tables replicated.
    """
    from qvz_tpu.ops.quantize import _quantize_device

    def step(data_t, draws_t, cluster_base, ctxmap, pair_base, qratio,
             qv_flat, qs_flat):
        return _quantize_device(data_t, draws_t, cluster_base, columns,
                                ctxmap, pair_base, qratio, qv_flat, qs_flat)

    fn = shard_map(
        step, mesh=mesh,
        in_specs=(P(None, READS_AXIS), P(None, READS_AXIS), P(READS_AXIS),
                  P(), P(), P(), P(), P()),
        out_specs=(P(None, READS_AXIS),) * 3,
    )
    return jax.jit(fn)


def quantize_sharded_t(mesh, tables, data: np.ndarray, cluster_ids,
                       draws: np.ndarray):
    """Mesh data-parallel quantization returning column-major (cols, N)
    numpy arrays (model_t u32, qs_t u8, qv_t u8); bit-identical to the
    1-device ops.quantize path (pure integer gathers, no collectives)."""
    import jax.numpy as jnp

    n, cols = data.shape
    n_dev = mesh.devices.size
    dpad, _ = pad_reads(data, n_dev)
    drpad, _ = pad_reads(draws, n_dev)
    if cluster_ids is None:
        cbase = np.zeros(dpad.shape[0], dtype=np.int32)
    else:
        cpad, _ = pad_reads(np.asarray(cluster_ids), n_dev)
        cbase = cpad.astype(np.int32) * cols
    fn = make_sharded_quantize(mesh, cols)
    model_ids, qs, qv = fn(
        jnp.asarray(dpad.T, dtype=jnp.int32),
        jnp.asarray(drpad.T, dtype=jnp.int32),
        jnp.asarray(cbase),
        jnp.asarray(tables.ctxmap.reshape(-1), dtype=jnp.int32),
        jnp.asarray(tables.pair_base, dtype=jnp.int32),
        jnp.asarray(tables.qratio, dtype=jnp.int32),
        jnp.asarray(tables.qv_map.reshape(-1), dtype=jnp.int32),
        jnp.asarray(tables.qs_map.reshape(-1), dtype=jnp.int32))
    return (np.asarray(model_ids, dtype=np.uint32)[:, :n],
            np.asarray(qs, dtype=np.uint8)[:, :n],
            np.asarray(qv, dtype=np.uint8)[:, :n])


def pad_reads(arr: np.ndarray, n_shards: int, axis: int = 0):
    """Pad the reads axis to a shard multiple; returns (padded, valid)."""
    n = arr.shape[axis]
    npad = pad_to_multiple(n, n_shards)
    valid = np.zeros(npad, dtype=bool)
    valid[:n] = True
    if npad == n:
        return arr, valid
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, npad - n)
    return np.pad(arr, widths), valid


def kmeans_cluster_sharded(mesh, data: np.ndarray, n_clusters: int,
                           threshold: float, rand=None,
                           verbose: bool = False):
    """Mesh data-parallel k-means; bit-identical to the 1-device path
    (integer psum accumulators, integer-division means). API-compatible
    with ops.kmeans.kmeans_cluster."""
    from qvz_tpu.constants import MAX_KMEANS_ITERATIONS
    from qvz_tpu.spec import kmeans as spec_kmeans
    from qvz_tpu.spec.kmeans import seed_centroids

    n, cols = data.shape
    if n_clusters == 1:
        return np.zeros(n, dtype=np.uint8), data[:1].copy(), 0
    means = seed_centroids(data, n_clusters, rand,
                           verbose=verbose).astype(np.int64)
    dpad, valid = pad_reads(data, mesh.devices.size)
    step = make_sharded_kmeans_step(mesh, n_clusters)
    dt = jnp.asarray(dpad.T, dtype=jnp.int32)
    v = jnp.asarray(valid)
    iters = 0
    assign = None
    while iters < MAX_KMEANS_ITERATIONS:
        assign, new_means, moved = step(
            dt, jnp.asarray(means, dtype=jnp.int32), v)
        iters += 1
        new_np = np.asarray(new_means, dtype=np.int64)
        if verbose:
            spec_kmeans.verbose_iteration(means, new_np)
        means = new_np
        if float(moved) <= threshold:
            break
    if verbose:
        spec_kmeans.verbose_total(iters)
    return (np.asarray(assign, dtype=np.uint8)[:n],
            means.astype(np.uint8), iters)


def sharded_conditional_counts(mesh, data: np.ndarray, clusters, n_clusters):
    """Host API: sharded equivalent of ops.stats.conditional_counts."""
    n, cols = data.shape
    n_shards = mesh.devices.size
    if clusters is None:
        clusters = np.zeros(n, dtype=np.uint8)
    dpad, valid = pad_reads(data, n_shards)
    cpad, _ = pad_reads(np.asarray(clusters), n_shards)
    fn = make_sharded_stats(mesh, n_clusters)
    c0, cond = fn(jnp.asarray(dpad.T, dtype=jnp.int32),
                  jnp.asarray(cpad, dtype=jnp.int32),
                  jnp.asarray(valid))
    c0 = np.asarray(c0, dtype=np.int64)
    cond = np.asarray(cond, dtype=np.int64)
    return c0, cond.reshape(cols - 1, n_clusters, A, A).transpose(1, 0, 2, 3)
