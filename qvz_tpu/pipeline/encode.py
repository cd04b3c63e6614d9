"""Production encoder pipeline.

Phase structure mirrors the reference driver (src/main.c:18-127) with the
heavy per-read passes on the accelerator and exact-semantics host steps
in C++:

  1. load quality file                      (numpy, host)
  2. k-means clustering                     (JAX on device, or C++)
  3. conditional statistics                 (JAX on device, or C++)
  4. codebook design                        (C++, exact doubles)
  5. fused quantize + WELL dither + coding  (C++, single sequential pass)
  6. container assembly                     (host)

The bit-exact container interleaves every line into ONE adaptive
arithmetic stream (qv_compressor.c:76-137), so the coding pass is
inherently sequential; fusing quantization + dithering + coding into one
C++ pass avoids materializing per-symbol model ids and dither draws. The
device quantization kernel (ops/quantize.py) remains the production path
for the sharded throughput mode, where each shard owns its own stream.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field

import numpy as np

from qvz_tpu.constants import MODE_RATIO, PHRED_OFFSET
from qvz_tpu.format import container
from qvz_tpu.native import runtime as rt
from qvz_tpu.ops.well import WellState
from qvz_tpu.spec.pipeline import lines_to_bytes, load_quality_file  # noqa: F401


@dataclass
class EncodeStats:
    lines: int = 0
    columns: int = 0
    payload_bytes: int = 0
    distortion: float = 0.0
    rate: float = 0.0
    phase_seconds: dict = field(default_factory=dict)
    # Seconds per phase that executed on the accelerator (subset of
    # phase_seconds, incl. host<->device transfer). Phases absent here
    # ran entirely on host — makes the device/host split visible to
    # --profile consumers.
    device_seconds: dict = field(default_factory=dict)
    # Device-coder lanes that fell back to host coding (rescale inside
    # a column model / oversize emission — exactness checks, rare).
    coder_fallback_lanes: int = 0


@dataclass
class EncodeOutput:
    compressed: bytes
    reconstructed: np.ndarray  # (N, cols) quantized symbols
    clusters: np.ndarray
    stats: EncodeStats


def _device_coder_enabled() -> bool:
    """The device entropy coder is the default device path; 0 falls
    back to device-quantize + host coding (diagnostics)."""
    return os.environ.get("QVZ_TPU_DEVICE_CODER", "1") != "0"


def _device_worthwhile(n_bytes: int) -> bool:
    """Auto-dispatch policy: run the batched passes on the accelerator
    only when JAX's default backend is a GPU and the input is large
    enough to amortize host<->device transfer and compile latency;
    below the threshold, and on a CPU-only backend, the C++ host engine
    wins. The size threshold is tunable per deployment via
    QVZ_TPU_DEVICE_MIN_BYTES (bytes)."""
    import jax

    if jax.default_backend() != "gpu":
        return False
    thresh = int(os.environ.get("QVZ_TPU_DEVICE_MIN_BYTES", 256 * 2**20))
    return n_bytes >= thresh


# Warmup-shard size for primed QVZ2 encodes: shard 0 is capped at this
# many lines so the serial warmup stage stays a small fraction of the
# wall time while the adaptive models still see enough symbols to
# converge (the adaptation redundancy is concentrated in each model's
# first ~hundred updates). Overridable for experiments.
PRIME_WARMUP_LINES = int(os.environ.get("QVZ_TPU_WARMUP_LINES", 65536))


def _shard_plan(n: int, columns: int, shards: int, warmup: int = 0):
    """Split n lines into <= `shards` contiguous shards whose dither-draw
    offsets land on WELL pool-word boundaries (4 draws per 32-bit pool
    word, well.c:33-46), so jump-ahead start states are exact.

    warmup > 0: shard 0 is a warmup shard of ~`warmup` lines (model-bank
    priming source); the remaining lines split evenly across the other
    shards."""
    if warmup > 0 and shards > 1 and n > 2 * warmup:
        # rest splits across `shards` full shards (warmup is an EXTRA
        # small shard: the parallel coding stage must still use every
        # core, so total shard count is shards+1)
        w = max(4, (min(warmup, n // 2) + 3) & ~3)
        rest = n - w
        per = -(-rest // shards)
        per = max(4, (per + 3) & ~3)
        counts = [w]
        left = rest
        while left > 0:
            take = min(per, left)
            counts.append(take)
            left -= take
        return counts
    per = -(-n // shards)
    per = max(4, (per + 3) & ~3)  # multiple of 4 => 4 | per*columns
    counts = []
    left = n
    while left > 0:
        take = min(per, left)
        counts.append(take)
        left -= take
    return counts


def encode(data: np.ndarray, dist_matrix: np.ndarray, *,
           n_clusters: int = 1, mode: int = MODE_RATIO, ratio: float = 0.5,
           cluster_threshold: float = 4.0,
           well_state: WellState | None = None,
           use_jax: bool | str = "auto",
           shards: int = 1,
           mesh=None,
           reuse_blocks: bytes | None = None,
           want_recon: bool = True,
           prime: bool = True,
           verbose: bool = False) -> EncodeOutput:
    """mesh: optional jax.sharding.Mesh with a 'reads' axis — the heavy
    statistics/clustering passes then run data-parallel over its devices
    with integer psum merging (bit-identical to the 1-device path).

    reuse_blocks: serialized codebook blocks from a previous encode
    (the container's codebook section) — skips the statistics and
    design phases entirely. The design phase is the pipeline's natural
    checkpoint boundary (SURVEY §5): its output fully determines the
    coder, and coding is restartable per shard. Clustering must still
    assign reads; with reuse the k-means centroids are re-derived from
    the data (cluster ids are per-read, not in the blocks).

    prime (QVZ2 only): shards 1..N-1 start their adaptive models from
    the bank state after a small warmup shard 0, removing nearly all of
    the per-shard adaptation-restart rate overhead at zero container
    cost (both sides derive the prior by processing shard 0)."""
    n, columns = data.shape
    if use_jax == "auto":
        use_jax = mesh is not None or _device_worthwhile(data.nbytes)
    if shards == 0:
        # shards=0 = "pick for the execution engine": host coding wants
        # one stream per core; the device coder wants many lanes, which
        # shrink its sequential scan. Priming keeps the per-shard rate
        # cost ~zero, so lanes are nearly free; a floor of 256 lines
        # per lane bounds padding + per-lane flush overhead. This
        # formula fixes the `--shards 0` container layout, so it stays
        # as it is until a benchmark cell justifies another.
        if use_jax and _device_coder_enabled():
            shards = int(os.environ.get("QVZ_TPU_DEVICE_LANES", "0")) or \
                max(16, min(8192, max(n // 256, -(-n // 1536))))
        else:
            shards = os.cpu_count() or 1
    shards = max(1, min(shards, n))
    if well_state is None:
        well_state = WellState.debug()
    stats = EncodeStats(lines=n, columns=columns)
    data_dev = None
    if use_jax and mesh is None:
        # ONE h2d upload of the quality matrix, shared by the stats and
        # quantize phases (transposes happen on device).
        import jax
        data_dev = jax.device_put(data)
    t0 = time.perf_counter()

    # --- clustering -------------------------------------------------------
    if n_clusters == 1:
        clusters = None
        cluster_arr = np.zeros(n, dtype=np.uint8)
    elif mesh is not None:
        from qvz_tpu.parallel import sharded
        cluster_arr, _, _ = sharded.kmeans_cluster_sharded(
            mesh, data, n_clusters, cluster_threshold, verbose=verbose)
        clusters = cluster_arr
    elif use_jax:
        from qvz_tpu.ops import kmeans as jx_kmeans
        cluster_arr, _, _ = jx_kmeans.kmeans_cluster(
            data, n_clusters, cluster_threshold, verbose=verbose)
        clusters = cluster_arr
    else:
        cluster_arr, _, _ = rt.kmeans_host(
            data, n_clusters, cluster_threshold, verbose=verbose)
        clusters = cluster_arr
    t1 = time.perf_counter()
    stats.phase_seconds["cluster"] = t1 - t0
    if n_clusters > 1 and (mesh is not None or use_jax):
        stats.device_seconds["cluster"] = t1 - t0
    if verbose:
        # reference phase print, main.c:56-58 (same %.4f format)
        print(f"Clustering took {t1 - t0:.4f} seconds")

    # --- checkpoint reuse: skip stats + design entirely ---------------------
    if reuse_blocks is not None:
        tables = rt.tables_from_blocks(reuse_blocks, n_clusters, columns)
        blocks = reuse_blocks[:tables.consumed]
        t3 = time.perf_counter()
        stats.phase_seconds["stats"] = 0.0
        stats.phase_seconds["design"] = t3 - t1
        return _finish_encode(data, dist_matrix, clusters, cluster_arr,
                              blocks, tables, n, columns, n_clusters,
                              shards, well_state, want_recon, stats, t3,
                              use_jax=use_jax, mesh=mesh, prime=prime,
                              verbose=verbose, data_dev=data_dev)

    # --- statistics ---------------------------------------------------------
    if mesh is not None:
        from qvz_tpu.parallel import sharded
        counts0, cond_counts = sharded.sharded_conditional_counts(
            mesh, data, cluster_arr, n_clusters)
    elif use_jax:
        from qvz_tpu.ops import stats as jx_stats
        counts0, cond_counts = jx_stats.conditional_counts(
            data_dev if data_dev is not None else data, cluster_arr,
            n_clusters)
    else:
        counts0, cond_counts = rt.stats_host(data, cluster_arr, n_clusters)
    t2 = time.perf_counter()
    stats.phase_seconds["stats"] = t2 - t1
    if mesh is not None or use_jax:
        stats.device_seconds["stats"] = t2 - t1

    # --- codebook design ------------------------------------------------------
    design = rt.Design(np.asarray(counts0), np.asarray(cond_counts),
                       mode, ratio, dist_matrix)
    blocks = design.serialized()
    tables = design.tables()
    t3 = time.perf_counter()
    stats.phase_seconds["design"] = t3 - t2
    if verbose:
        # reference combines stats + codebook generation in one timer
        # (main.c:61-67)
        print(f"Stats and codebook generation took {t3 - t1:.4f} "
              "seconds")

    return _finish_encode(data, dist_matrix, clusters, cluster_arr, blocks,
                          tables, n, columns, n_clusters, shards,
                          well_state, want_recon, stats, t3,
                          use_jax=use_jax, mesh=mesh, prime=prime,
                          verbose=verbose, data_dev=data_dev)


def _shard_draws(states: np.ndarray, counts, columns: int) -> np.ndarray:
    """All 7-bit dither draws for the file in (line, col) order, filled
    in parallel from the per-shard GF(2) jump-ahead start states (the
    single logical WELL stream split at pool-word boundaries)."""
    from concurrent.futures import ThreadPoolExecutor

    n = int(sum(counts))
    draws = np.empty((n, columns), dtype=np.uint8)
    offs = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)

    def fill(s):
        lo, hi = offs[s], offs[s + 1]
        draws[lo:hi] = rt.well_draws7(
            states[s], (hi - lo) * columns).reshape(hi - lo, columns)

    with ThreadPoolExecutor(max_workers=min(len(counts),
                                            os.cpu_count() or 1)) as ex:
        list(ex.map(fill, range(len(counts))))
    return draws


def _device_coder_encode(tables, data, clusters, cluster_arr, states,
                         counts, offs, columns, n_clusters, dist_matrix,
                         prime_on, want_recon, stats, draws,
                         data_dev=None, mesh=None):
    """Quantize + entropy-code the QVZ2 shards on the accelerator.

    The warmup shard (priming source) is coded on host — it is the one
    serial stage and its bank snapshot seeds the device lanes. Every
    other shard becomes one device lane; lanes the exactness checks
    flag (a rescaling column model, an oversize emission — both rare at
    device shard sizes) are re-coded on host from the device streams,
    so the container is byte-identical to the host path always.

    mesh: both the quantize map AND the lane coder shard over the
    device mesh (lane axis, no collectives) — the full multi-chip
    encode path; containers stay byte-identical to the host path."""
    import jax.numpy as jnp

    from qvz_tpu.ops import coder_device
    from qvz_tpu.ops import quantize as jx_quant

    t0 = time.perf_counter()
    if mesh is not None:
        from qvz_tpu.parallel import sharded
        md, qd, qv_host = sharded.quantize_sharded_t(
            mesh, tables, data,
            cluster_arr if clusters is not None else None, draws)
        qvd = data_t_dev = None
    else:
        md, qd, qvd, data_t_dev = jx_quant.quantize_t_device(
            tables, data_dev if data_dev is not None else data,
            cluster_arr if clusters is not None else None, draws)
        md.block_until_ready()
    t1 = time.perf_counter()
    stats.phase_seconds["quantize"] = t1 - t0
    stats.device_seconds["quantize"] = t1 - t0
    if mesh is None:   # LAST_TIMINGS is quantize_t_device's record
        for k, v in jx_quant.LAST_TIMINGS.items():
            stats.phase_seconds[f"quantize/{k}"] = round(v, 3)
        if jx_quant.LAST_TIMINGS:
            stats.phase_seconds["quantize/kernel"] = round(
                (t1 - t0) - sum(jx_quant.LAST_TIMINGS.values()), 3)

    first = 1 if prime_on else 0
    bank = None
    pay0 = None
    warmup_thread = None
    warmup_out: list = [None]
    if prime_on:
        # The primed bank is derivable from the warmup shard's quantize
        # DECISIONS alone (bank updates are interval-independent), so
        # the warmup's serial payload coding — the one non-parallel
        # stage — runs in a host thread CONCURRENTLY with the device
        # lanes instead of gating them.
        import threading

        w_n = int(counts[0])
        w_cl = clusters[:w_n] if clusters is not None else None
        md0, qs0, _, _ = rt.quantize_colmajor(
            tables, np.ascontiguousarray(data[:w_n].T), w_cl, states[0])
        bank = rt.bank_from_stream(tables, md0, qs0, w_cl, w_n)

        def _code_warmup():
            warmup_out[0] = rt.encode_precomputed_colmajor(
                tables, md0, qs0, w_cl, w_n)

        warmup_thread = threading.Thread(target=_code_warmup)
        warmup_thread.start()
    plan = coder_device.LanePlan(tables, bank)

    lane_counts = counts[first:]
    W = len(lane_counts)
    L = int(lane_counts[0])
    base = int(offs[first])

    ctrip = None
    if n_clusters > 1:
        # cluster-id segment: exact host replay (it rescales at one
        # update per line; pass 1 covers only rescale-free models)
        ctrip = np.zeros((W, L, 3), dtype=np.uint32)
        ctrip[:, :, 1] = 1
        ctrip[:, :, 2] = 1
        for w in range(W):
            lo, hi = int(offs[first + w]), int(offs[first + w + 1])
            ctrip[w, : hi - lo] = rt.replay_model(
                plan.cluster_init_counts, plan.cluster_init_total,
                cluster_arr[lo:hi])

    tim = {} if os.environ.get("QVZ_TPU_CODER_TIMINGS") else None
    lane_pays, flags = coder_device.encode_lanes(
        plan, md, qd, lane_counts, base, ctrip, timings=tim, mesh=mesh)
    if tim:
        for k, v in tim.items():
            stats.phase_seconds[f"device_code/{k}"] = v
    if warmup_thread is not None:
        warmup_thread.join()
        pay0 = warmup_out[0]
    t2 = time.perf_counter()
    stats.phase_seconds["device_code"] = t2 - t1
    stats.device_seconds["device_code"] = t2 - t1
    stats.coder_fallback_lanes = int(flags.sum())

    for w in range(W):
        if lane_pays[w] is not None:
            continue
        lo, hi = int(offs[first + w]), int(offs[first + w + 1])
        lane_pays[w] = rt.encode_precomputed_colmajor(
            tables,
            np.ascontiguousarray(np.asarray(md[:, lo:hi],
                                            dtype=np.uint32)),
            np.ascontiguousarray(np.asarray(qd[:, lo:hi],
                                            dtype=np.uint8)),
            clusters[lo:hi] if clusters is not None else None,
            hi - lo, init_bank=bank)

    if mesh is not None:
        # mesh quantize returned host (cols, N) u8 reconstruction
        recon = qv_host.T.copy() if want_recon else None
        dist_sum = float(
            dist_matrix[data.reshape(-1), qv_host.T.reshape(-1)].sum()
        ) / columns
    elif want_recon:
        # cast on device: the d2h fetch is 1 B/symbol, not 4
        recon = np.asarray(qvd.astype(jnp.uint8)).T.copy()
        dist_sum = float(
            dist_matrix[data.reshape(-1), recon.reshape(-1)].sum()
        ) / columns
    else:
        recon = None
        dist_sum = jx_quant.distortion_device(
            data_t_dev, qvd, dist_matrix) / columns

    payloads = ([pay0] if prime_on else []) + lane_pays
    return payloads, dist_sum, recon


def _finish_encode(data, dist_matrix, clusters, cluster_arr, blocks, tables,
                   n, columns, n_clusters, shards, well_state, want_recon,
                   stats, t3, use_jax=False, mesh=None, prime=True,
                   data_dev=None,
                   verbose=False):
    # --- fused quantize + dither + entropy coding -----------------------------
    well_bytes = well_state.to_bytes()
    order = [(well_state.n + i) & 31 for i in range(32)]
    state_words = np.asarray(well_state.state, dtype=np.uint32)[order]

    if shards == 1:
        payload, recon, dist_sum = rt.encode_fused(
            tables, data, clusters, state_words, dist=dist_matrix,
            want_recon=want_recon, verbose=verbose)
        payload_bytes = len(payload)
        compressed = None  # assembled below
    else:
        from concurrent.futures import ThreadPoolExecutor

        from qvz_tpu.format import container_v2

        # Adaptive warmup: an eighth of the file, capped — rate overhead
        # vs v1 measured at 500k x 100 / 4 shards: unprimed +0.69%,
        # 32k warmup +0.10%, 64k +0.06% (the <0.1% target).
        warmup = min(PRIME_WARMUP_LINES, max(8192, n // 12)) if prime else 0
        prime_on = warmup > 0 and shards > 1 and n > 2 * warmup
        counts = _shard_plan(n, columns, shards,
                             warmup=warmup if prime_on else 0)
        prime_on = prime_on and len(counts) > 1
        # Per-shard WELL start states: shard s begins exactly
        # counts[0..s)*columns draws into the single logical stream.
        if prime_on:
            # non-uniform plan: jump over the warmup shard, then equal
            # chunks from there
            base2 = rt.well_jump(state_words, 2, counts[0] * columns // 4)
            rest = rt.well_jump(base2[1], len(counts) - 1,
                                counts[1] * columns // 4)
            states = np.vstack([state_words[None, :], rest])
        else:
            wpc = counts[0] * columns // 4
            states = rt.well_jump(state_words, len(counts), wpc)
        offs = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)

        device_coder = use_jax and _device_coder_enabled()
        if device_coder:
            # Device-CODER production path: the
            # accelerator quantizes AND entropy-codes every non-warmup
            # shard in parallel lanes (ops/coder_device.py); the
            # device->host transfer is the compressed payload itself,
            # not per-symbol intermediates. With a mesh, both stages
            # shard over it (quantize on reads, coder on lanes).
            td0 = time.perf_counter()
            draws = _shard_draws(states, counts, columns)
            td1 = time.perf_counter()
            stats.phase_seconds["draws"] = td1 - td0
            payloads, dist_sum, recon = _device_coder_encode(
                tables, data, clusters, cluster_arr, states, counts,
                offs, columns, n_clusters, dist_matrix, prime_on,
                want_recon, stats, draws, data_dev=data_dev, mesh=mesh)
        elif use_jax or mesh is not None:
            # Device-quantization production path: the accelerator runs
            # the batched quantize+dither scan over ALL reads at once
            # (the per-symbol loop qv_compressor.c:86-118 as vectorized
            # gathers); host shard threads then only advance the
            # adaptive arithmetic streams. Payload bytes are identical
            # to the fused host path (same decisions, same models).
            td0 = time.perf_counter()
            draws = _shard_draws(states, counts, columns)
            td1 = time.perf_counter()
            stats.phase_seconds["draws"] = td1 - td0
            if mesh is not None:
                from qvz_tpu.parallel import sharded
                model_t, qs_t, qv_t = sharded.quantize_sharded_t(
                    mesh, tables, data,
                    cluster_arr if clusters is not None else None, draws)
            else:
                from qvz_tpu.ops import quantize as jx_quant
                model_t, qs_t, qv_t = jx_quant.quantize_t(
                    tables, data,
                    cluster_arr if clusters is not None else None, draws)
            td2 = time.perf_counter()
            stats.phase_seconds["quantize"] = td2 - td1
            stats.device_seconds["quantize"] = td2 - td1

            def run(s, init_bank=None, want_bank=False):
                lo, hi = offs[s], offs[s + 1]
                return rt.encode_precomputed_colmajor(
                    tables, np.ascontiguousarray(model_t[:, lo:hi]),
                    np.ascontiguousarray(qs_t[:, lo:hi]),
                    clusters[lo:hi] if clusters is not None else None,
                    hi - lo, init_bank=init_bank, want_bank=want_bank)

            if prime_on:
                # serial warmup stage: shard 0 derives the shared prior
                pay0, bank = run(0, want_bank=True)
                with ThreadPoolExecutor(
                        max_workers=min(len(counts) - 1,
                                        os.cpu_count() or 1)) as ex:
                    payloads = [pay0] + list(ex.map(
                        lambda s: run(s, init_bank=bank),
                        range(1, len(counts))))
            else:
                with ThreadPoolExecutor(
                        max_workers=min(len(counts),
                                        os.cpu_count() or 1)) as ex:
                    payloads = list(ex.map(run, range(len(counts))))
            # Distortion accounting from the device-computed recon
            # (display-only; fp addition order differs from the host
            # fused pass in the last bits, well inside the -s %.4f).
            dist_sum = float(
                dist_matrix[data.reshape(-1),
                            qv_t.T.reshape(-1)].sum()) / columns
            recon = qv_t.T.copy() if want_recon else None
        # (A split-pass host flow — parallel quantize_colmajor for every
        # shard, then coding from precomputed pairs — was measured at
        # parity or slightly WORSE than the fused pass here: the coding
        # loop alone runs 1.6x faster, but total work is unchanged and
        # the 5 B/symbol intermediates eat shared memory bandwidth on a
        # 4-core host. The fused flow stays; rt.quantize_colmajor
        # remains available as the host analog of the device quantize.)
        else:
            def run(s, init_bank=None, want_bank=False):
                lo, hi = offs[s], offs[s + 1]
                # each worker transposes its own shard (one copy each)
                return rt.encode_fused_colmajor(
                    tables, np.ascontiguousarray(data[lo:hi].T),
                    clusters[lo:hi] if clusters is not None else None,
                    states[s], dist=dist_matrix, want_recon=want_recon,
                    init_bank=init_bank, want_bank=want_bank)

            if prime_on:
                # serial warmup stage: shard 0 derives the shared prior
                p0, r0, d0, bank = run(0, want_bank=True)
                with ThreadPoolExecutor(
                        max_workers=min(len(counts) - 1,
                                        os.cpu_count() or 1)) as ex:
                    results = [(p0, r0, d0)] + list(ex.map(
                        lambda s: run(s, init_bank=bank),
                        range(1, len(counts))))
            else:
                with ThreadPoolExecutor(
                        max_workers=min(len(counts),
                                        os.cpu_count() or 1)) as ex:
                    results = list(ex.map(run, range(len(counts))))
            payloads = [r[0] for r in results]
            dist_sum = float(sum(r[2] for r in results))
            recon = (np.concatenate([r[1] for r in results])
                     if want_recon else None)
        shard_states = [np.asarray(states[s], dtype="<u4").tobytes()
                        for s in range(len(counts))]
        compressed = container_v2.build(
            blocks, n_clusters, columns, n, counts, shard_states, payloads,
            priming=1 if prime_on else 0)
        payload_bytes = sum(len(p) for p in payloads)
    t4 = time.perf_counter()
    # "code" covers only the entropy-coding pass; the device path's
    # draws/quantize sub-phases are reported separately above.
    t_code_start = t3 + stats.phase_seconds.get("draws", 0.0) \
        + stats.phase_seconds.get("quantize", 0.0)
    stats.phase_seconds["code"] = t4 - t_code_start

    if compressed is None:
        compressed = container.build_container_raw(
            blocks, n_clusters, well_bytes, payload, columns, n)

    stats.payload_bytes = payload_bytes
    stats.rate = (payload_bytes * 8.0) / (float(n) * columns)
    stats.distortion = dist_sum / n
    return EncodeOutput(compressed, recon, cluster_arr, stats)
