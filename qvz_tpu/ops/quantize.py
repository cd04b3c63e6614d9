"""Batched quantization pass on device (reference: src/qv_compressor.c:76-136).

Per line, per column the encoder (a) looks up the context index of the
previously *quantized* symbol, (b) dithers between the lo/hi quantizer
with a precomputed 7-bit WELL draw, (c) maps the raw symbol through the
chosen quantizer, and (d) emits the output-alphabet state index plus the
adaptive-model id for the coder. The column recursion is sequential (the
context is the previous quantized value) but embarrassingly parallel over
reads: a lax.scan over columns carrying the (N,) previous-symbol vector,
with all table lookups as vectorized gathers. All ops are exact integer,
so results are bit-identical to the host path.
"""

from __future__ import annotations

import os
import time

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from qvz_tpu.constants import ALPHABET_SIZE

# sub-phase timings of the LAST quantize_t_device call (populated only
# under QVZ_TPU_CODER_TIMINGS=1; read by pipeline/encode.py)
LAST_TIMINGS: dict = {}


@partial(jax.jit, static_argnames=("columns",))
def _quantize_device(data_t, draws_t, cluster_base, columns,
                     ctxmap_flat, pair_base, qratio, qv_flat, qs_flat):
    """data_t/draws_t: (cols, N) int32 or uint8 (uint8 inputs are cast
    on DEVICE — callers upload the 1 B/symbol arrays, not 4x-inflated
    host-side int32 conversions); cluster_base: (N,) int32 = cluster*cols.
    Tables flat int32. Returns (model_ids, qs, qv) each (cols, N)
    int32."""
    A = ALPHABET_SIZE
    data_t = data_t.astype(jnp.int32)
    draws_t = draws_t.astype(jnp.int32)

    def step(prev, xs):
        col, data_col, draw_col = xs
        cc = cluster_base + col              # (N,) cluster*cols + col
        ctx = ctxmap_flat[cc * A + prev]     # (N,)
        p = pair_base[cc] + ctx
        choice = (draw_col >= qratio[p]).astype(jnp.int32)
        pc = p * 2 + choice
        flat = pc * A + data_col
        qv = qv_flat[flat]
        qs = qs_flat[flat]
        model_id = 1 + pc
        return qv, (model_id, qs, qv)

    cols_idx = jnp.arange(columns, dtype=jnp.int32)
    prev0 = jnp.zeros_like(data_t[0])
    _, (model_ids, qs, qv) = jax.lax.scan(
        step, prev0, (cols_idx, data_t, draws_t))
    return model_ids, qs, qv


def quantize_t_device(tables, data: np.ndarray, cluster_ids, draws):
    """Device quantization returning DEVICE arrays: (model_ids, qs, qv)
    each (cols, N) int32 jax arrays, plus data_t (cols, N) — feeds the
    device coder (ops/coder_device.py) without a 6 B/symbol
    device->host round-trip."""
    n, cols = data.shape
    # upload sub-phase (QVZ_TPU_CODER_TIMINGS=1, diagnostics only — the
    # wait breaks async overlap), surfaced as phase_seconds["quantize/..."]
    tm = {} if os.environ.get("QVZ_TPU_CODER_TIMINGS") == "1" else None
    LAST_TIMINGS.clear()
    t0 = time.perf_counter()
    # upload 1 B/symbol u8 and cast on device (see _quantize_device);
    # a jax-array input is already device-resident (one shared upload
    # for the stats + quantize phases) — transpose on device instead.
    if isinstance(data, np.ndarray):
        data_t = jnp.asarray(np.ascontiguousarray(data.T))
    else:
        data_t = data.T
    draws_t = jnp.asarray(np.ascontiguousarray(draws.T))
    if tm is not None:
        jax.block_until_ready((data_t, draws_t))
        tm["upload"] = time.perf_counter() - t0
        LAST_TIMINGS.update(tm)

    if cluster_ids is None:
        cluster_base = jnp.zeros(n, dtype=jnp.int32)
    else:
        cluster_base = jnp.asarray(cluster_ids, dtype=jnp.int32) * cols
    model_ids, qs, qv = _quantize_device(
        data_t, draws_t, cluster_base, cols,
        jnp.asarray(tables.ctxmap.reshape(-1), dtype=jnp.int32),
        jnp.asarray(tables.pair_base, dtype=jnp.int32),
        jnp.asarray(tables.qratio, dtype=jnp.int32),
        jnp.asarray(tables.qv_map.reshape(-1), dtype=jnp.int32),
        jnp.asarray(tables.qs_map.reshape(-1), dtype=jnp.int32))
    return model_ids, qs, qv, data_t


def quantize_t(tables, data: np.ndarray, cluster_ids, draws):
    """Device quantization returning COLUMN-MAJOR (cols, N) numpy arrays
    (model_t uint32, qs_t uint8, qv_t uint8) — the layout the QVZ2
    shard coders consume, so no host-side re-transpose is needed."""
    model_ids, qs, qv, _ = quantize_t_device(tables, data, cluster_ids,
                                             draws)
    return (np.asarray(model_ids, dtype=np.uint32),
            np.asarray(qs, dtype=np.uint8),
            np.asarray(qv, dtype=np.uint8))


@jax.jit
def _distortion_cols(data_t, qv_t, dist_f32):
    di = data_t.astype(jnp.int32)
    return jnp.take(dist_f32.reshape(-1),
                    di * dist_f32.shape[1] + qv_t).sum(axis=1)


def distortion_device(data_t, qv_t, dist_matrix) -> float:
    """Accumulated distortion sum(dist[x, qv]) computed on device from
    the quantize outputs — avoids pulling the 1 B/symbol qv stream back
    to host just for the -s/-v figure. f32 per-column partial sums,
    f64 host reduction: display-only divergence from the reference's
    per-line double chain (qv_compressor.c:97-118), well inside the
    printed %.4f (the device-quantize path already documents the same
    class of divergence)."""
    parts = _distortion_cols(data_t, qv_t,
                             jnp.asarray(dist_matrix, jnp.float32))
    return float(np.asarray(parts, dtype=np.float64).sum())


def quantize(tables, data: np.ndarray, cluster_ids, draws,
             want_recon: bool = True):
    """Device quantization; API-compatible with native.runtime.quantize."""
    model_t, qs_t, qv_t = quantize_t(tables, data, cluster_ids, draws)
    model_ids = model_t.T.copy()
    syms = qs_t.T.copy()
    recon = qv_t.T.copy() if want_recon else None
    return model_ids, syms, recon
