"""Conditional statistics on device (reference: src/codebook.c:185-220).

The reference walks every line incrementing per-(cluster, column, prev,
cur) counters. Here the same counts come from one int32 scatter-add
over every (line, column) transition into a flat (column, cluster*72 +
prev, cur) table: exact integer by construction, in any order.

It replaced an int8 one-hot matrix-product form: on an H100 SXM
(400 W power limit), at 2M x 151, that form took 77.9 ms (a Triton
GEMM fusion plus the one-hot build) against 7.7 ms for the scatter,
and XLA's int8 GEMM (jax 0.9.0) returned inexact k-means distances at
some shapes (ops/kmeans.py).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from qvz_tpu.constants import ALPHABET_SIZE

# Per-cell counts must stay below int32; 71 * chunk < 2^31 always holds for
# the count itself (counts are bounded by chunk lines).
_CHUNK = 8_000_000


def cond_hist(data: jnp.ndarray, clusters: jnp.ndarray, n_clusters: int,
              valid: jnp.ndarray | None = None):
    """data: (N, cols) int; clusters: (N,) int; valid: optional (N,)
    bool — rows marked False (reads-axis padding) count nowhere.
    Returns (counts0 (C, 72) int32, cond (cols-1, C*72, 72) int32)."""
    A = ALPHABET_SIZE
    ca = n_clusters * A
    cols = data.shape[1]
    d = data.astype(jnp.int32)
    base = clusters.astype(jnp.int32) * A                     # (N,)
    idx0 = base + d[:, 0]
    idx = ((jnp.arange(cols - 1, dtype=jnp.int32)[None, :] * ca
            + base[:, None] + d[:, :-1]) * A + d[:, 1:])      # (N, cols-1)
    if valid is not None:      # out-of-range -> dropped by the scatter
        idx0 = jnp.where(valid, idx0, ca)
        idx = jnp.where(valid[:, None], idx, (cols - 1) * ca * A)
    counts0 = jnp.zeros(ca, jnp.int32).at[idx0].add(1, mode="drop")
    cond = jnp.zeros((cols - 1) * ca * A, jnp.int32).at[
        idx.reshape(-1)].add(1, mode="drop")
    return counts0.reshape(n_clusters, A), cond.reshape(cols - 1, ca, A)


@partial(jax.jit, static_argnames=("n_clusters",))
def _hist_device(data_u8: jnp.ndarray, clusters_u8: jnp.ndarray,
                 n_clusters: int):
    """data_u8: (N, cols) uint8; clusters_u8: (N,) uint8 — the raw
    bytes are transferred as-is (4x less traffic than int32) and widened
    on device. Returns cond_hist's (counts0, cond)."""
    return cond_hist(data_u8, clusters_u8, n_clusters)


def conditional_counts(data: np.ndarray, clusters: np.ndarray | None,
                       n_clusters: int):
    """Host API matching qvz_tpu.spec.stats.conditional_counts.

    Chunks the reads axis so per-cell int32 counts cannot overflow, and
    accumulates chunk results in int64 on host.
    """
    A = ALPHABET_SIZE
    n, cols = data.shape
    if clusters is None:
        clusters = np.zeros(n, dtype=np.uint8)
    counts0 = np.zeros((n_clusters, A), dtype=np.int64)
    cond = np.zeros((n_clusters, cols - 1, A, A), dtype=np.int64)
    is_dev = not isinstance(data, np.ndarray)
    # The reads-axis chunking bounds the per-chunk int32 counts; the
    # CROSS-chunk sums stay exact in int32 for
    # any n < 2^31 (a cell cannot exceed n), so accumulate them ON
    # DEVICE and fetch once.
    dev_acc = n < (1 << 31)
    acc0 = accd = None
    for s in range(0, n, _CHUNK):
        e = min(n, s + _CHUNK)
        if is_dev:
            dt = data[s:e].astype(jnp.uint8)  # already on device
        else:
            dt = jnp.asarray(np.ascontiguousarray(data[s:e]),
                             dtype=jnp.uint8)
        cl = jnp.asarray(clusters[s:e], dtype=jnp.uint8)
        c0, cd = _hist_device(dt, cl, n_clusters)
        if dev_acc:
            acc0 = c0 if acc0 is None else acc0 + c0
            accd = cd if accd is None else accd + cd
        else:
            counts0 += np.asarray(c0, dtype=np.int64)
            cd = np.asarray(cd, dtype=np.int64)  # (cols-1, C*72, 72)
            cond += cd.reshape(cols - 1, n_clusters, A,
                               A).transpose(1, 0, 2, 3)
    if dev_acc and acc0 is not None:
        counts0 += np.asarray(acc0, dtype=np.int64)
        cdh = np.asarray(accd, dtype=np.int64)
        cond += cdh.reshape(cols - 1, n_clusters, A,
                            A).transpose(1, 0, 2, 3)
    return counts0, cond
