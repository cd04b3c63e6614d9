"""k-means read clustering on device (reference: src/cluster.c).

Bitstream parity requires exact integer semantics (see spec/kmeans.py).
Everything on device is integer so results are bit-identical to the
reference: exact int32 squared-L2 distances, first-minimum
assignment, integer segment-sum accumulators and integer-division
centroid updates. The convergence loop runs on host (data-dependent
trip count), one jitted step per iteration.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from qvz_tpu.constants import MAX_KMEANS_ITERATIONS
from qvz_tpu.utils.glibc_rand import GlibcRand
from qvz_tpu.spec.kmeans import seed_centroids


def first_min_assign(data_i32: jnp.ndarray, means: jnp.ndarray):
    """Nearest centroid per read, lowest index on ties (the reference's
    strict-< scan, cluster.c:158-163; argmin returns the first
    minimum). data_i32: (N, cols); means: (K, cols) int32.

    Exact int32 squared distances, summed elementwise: K <= 5, so a
    matrix product buys nothing, and on an H100 (XLA of jax 0.9.0) the
    former ||x||^2 - 2 x.m + ||m||^2 form, with x.m as an int8 matrix
    product, returned inexact distances at some read counts (3703, 3707
    and 3708 of one 101-column input) and exact ones at others."""
    dist = jnp.sum(jnp.square(data_i32[:, None, :] - means[None, :, :]),
                   axis=2, dtype=jnp.int32)                    # (N, K)
    return jnp.argmin(dist, axis=1).astype(jnp.int32)


@partial(jax.jit, static_argnames=("n_clusters",))
def _kmeans_step(data_u8: jnp.ndarray, means: jnp.ndarray,
                 n_clusters: int):
    """One Lloyd iteration. data_u8: (N, cols) uint8 (raw symbols,
    transferred once and widened on device); means: (K, cols) int32.
    Returns (assign (N,) int32, new_means, moved (f32 scalar))."""
    data_i32 = data_u8.astype(jnp.int32)
    assign = first_min_assign(data_i32, means)

    counts = jax.ops.segment_sum(
        jnp.ones_like(assign), assign, num_segments=n_clusters)
    acc = jax.ops.segment_sum(data_i32, assign, num_segments=n_clusters)
    # Reference divides unconditionally (SIGFPE on an empty cluster,
    # cluster.c:113); guard only the empty case.
    new_means = acc // jnp.maximum(counts, 1)[:, None]
    diff = (new_means - means).astype(jnp.float32)
    moved = jnp.max(jnp.sum(diff * diff, axis=1))
    return assign, new_means, moved


def kmeans_cluster(data: np.ndarray, n_clusters: int, threshold: float,
                   rand: GlibcRand | None = None,
                   verbose: bool = False):
    """Reference-exact k-means; returns (assignments u8, means, iters)."""
    from qvz_tpu.spec import kmeans as spec_kmeans

    n, cols = data.shape
    if n_clusters == 1:
        return np.zeros(n, dtype=np.uint8), data[:1].copy(), 0

    means_np = seed_centroids(data, n_clusters, rand,
                              verbose=verbose).astype(np.int64)

    data_u8 = jnp.asarray(data, dtype=jnp.uint8)
    means = jnp.asarray(means_np, dtype=jnp.int32)
    iters = 0
    assign = None
    while iters < MAX_KMEANS_ITERATIONS:
        prev = np.asarray(means, dtype=np.int64) if verbose else None
        assign, means, moved = _kmeans_step(data_u8, means, n_clusters)
        iters += 1
        if verbose:
            spec_kmeans.verbose_iteration(
                prev, np.asarray(means, dtype=np.int64))
        if float(moved) <= threshold:
            break
    if verbose:
        spec_kmeans.verbose_total(iters)
    return (np.asarray(assign, dtype=np.uint8),
            np.asarray(means, dtype=np.uint8), iters)
