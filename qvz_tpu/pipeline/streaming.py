"""Bounded-memory streaming encode for beyond-RAM corpora.

The in-memory pipeline (pipeline/encode.py) materializes the full
(N, cols) symbol array — fine to a few GB, impossible for the
whole-genome-scale configs (BASELINE.json: 100M+ reads). This driver
keeps peak memory at O(chunk + workers * shard):

  1. statistics: one sequential pass over the np.memmap in chunks,
     accumulating the exact integer histograms in place (the OS streams
     pages; fadvise marks them sequential)
  2. k-means (optional): per-iteration chunked passes with the same
     integer accumulator merges as every other path — bit-identical
     assignments, stored as one uint8 per read
  3. design: unchanged (independent of line count)
  4. coding: shards stream through a bounded worker pool; each worker
     slices its shard from the memmap, strips the Phred offset, codes
     it, and hands the payload to a sequential container writer that
     appends payloads IN SHARD ORDER as they complete (out-of-order
     completions are buffered, bounded by the worker count) and
     backpatches the shard directory at the end
  5. the container is byte-identical to the in-memory encode for the
     same shard plan (tests/test_streaming.py)

Reference context: the reference mmaps the whole file (lines.c:64) and
is single-threaded, so its peak RSS is the file size; this driver's is
the chunk size.
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from qvz_tpu.constants import ALPHABET_SIZE, MODE_RATIO, PHRED_OFFSET
from qvz_tpu.format import container_v2
from qvz_tpu.native import runtime as rt
from qvz_tpu.ops.well import WellState
from qvz_tpu.pipeline.encode import PRIME_WARMUP_LINES, _shard_plan

A = ALPHABET_SIZE


def _geometry(path: str):
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        first = f.readline()
    columns = len(first) - 1
    if columns <= 0:
        raise ValueError("empty or malformed quality file")
    return size // (columns + 1), columns


def _rows(mm: np.ndarray, columns: int, lo: int, hi: int) -> np.ndarray:
    """Materialize rows [lo, hi) as 0-based symbols (one chunk copy)."""
    return np.ascontiguousarray(
        mm.reshape(-1, columns + 1)[lo:hi, :columns] - PHRED_OFFSET)


def _rows_t(mm: np.ndarray, columns: int, lo: int, hi: int) -> np.ndarray:
    """Rows [lo, hi) as a (cols, n) column-major symbol buffer — ONE
    shard-sized allocation (transpose + Phred strip in place)."""
    dt = np.ascontiguousarray(
        mm.reshape(-1, columns + 1)[lo:hi, :columns].T)
    dt -= PHRED_OFFSET  # uint8 wrap semantics, as everywhere
    return dt


def _drop_pages(mm: np.ndarray, columns: int, lo: int, hi: int) -> None:
    """Release the page-cache pages backing rows [lo, hi): keeps the
    streaming pass's resident set at O(chunk) instead of O(file)."""
    try:
        raw = mm._mmap  # np.memmap's underlying mmap object
        page = 4096
        start = (lo * (columns + 1)) // page * page
        end = hi * (columns + 1) // page * page
        if end > start:
            raw.madvise(getattr(__import__("mmap"), "MADV_DONTNEED"),
                        start, end - start)
    except (AttributeError, ValueError, OSError):
        pass  # advisory only


def _flush_drop(mm: np.ndarray, row_bytes: int, lo: int, hi: int) -> None:
    """msync then release the pages backing OUTPUT rows [lo, hi) of a
    writable memmap: the dirty reconstruction pages of a 10+ GB `-u`
    file would otherwise accumulate in the resident set until the
    final flush. Ordering matters — MADV_DONTNEED on still-dirty pages
    discards the data, so the range flush must land first."""
    try:
        import mmap as _mmap

        raw = mm._mmap
        page = 4096
        start = (lo * row_bytes) // page * page
        end = hi * row_bytes // page * page
        if end > start:
            raw.flush(start, end - start)
            raw.madvise(_mmap.MADV_DONTNEED, start, end - start)
    except (AttributeError, ValueError, OSError):
        pass  # advisory only


def encode_streaming(input_path: str, output_path: str, *,
                     n_clusters: int = 1, mode: int = MODE_RATIO,
                     ratio: float = 0.5, cluster_threshold: float = 4.0,
                     well_state: WellState | None = None,
                     dist_matrix: np.ndarray | None = None,
                     shards: int = 0,
                     max_shard_lines: int = 1_000_000,
                     chunk_lines: int = 1_000_000,
                     prime: bool = True,
                     reuse_blocks: bytes | None = None,
                     recon_path: str | None = None,
                     use_jax: bool = False,
                     verbose: bool = False) -> dict:
    """Encode a quality file to a QVZ2 container with bounded memory.

    Returns a stats dict (rate, distortion, payload_bytes, phase
    seconds). Peak memory ~ chunk_lines*cols (stats pass) +
    workers*max_shard_lines*cols (coding).

    reuse_blocks: serialized codebook blocks from a previous container
    (checkpoint/resume): skips the statistics and design phases.

    recon_path: write the lossy reconstruction (`-u`, Phred+33 text
    with newlines — reference write path qv_compressor.c:100-115) to
    this file, streamed per shard into a memory-mapped output so peak
    memory stays bounded; byte-identical to the in-memory path's
    reconstruction (same quantization decisions).

    use_jax: run the chunked statistics pass and the per-shard
    quantization on the accelerator (device outputs are the small
    count tensors / the precomputed coding streams; the adaptive
    arithmetic streams still advance on host threads). Containers are
    byte-identical to the host path; not yet measured on the GPU."""
    if well_state is None:
        well_state = WellState.debug()
    if dist_matrix is None:
        from qvz_tpu.constants import DISTORTION_MSE
        from qvz_tpu.ops.distortion import make_matrix
        dist_matrix = make_matrix(DISTORTION_MSE)

    n, columns = _geometry(input_path)
    if hasattr(os, "posix_fadvise"):
        try:
            fd = os.open(input_path, os.O_RDONLY)
            os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_SEQUENTIAL)
            os.close(fd)
        except OSError:
            pass
    mm = np.memmap(input_path, dtype=np.uint8, mode="r")
    stats = {"lines": n, "columns": columns}
    t0 = time.perf_counter()

    # --- k-means (chunked Lloyd iterations, bit-exact) -------------------
    assign = None
    if n_clusters > 1:
        from qvz_tpu.constants import MAX_KMEANS_ITERATIONS, \
            MAX_LINES_PER_BLOCK
        from qvz_tpu.utils.glibc_rand import GlibcRand

        rand = GlibcRand(1)
        block_count = -(-n // MAX_LINES_PER_BLOCK)
        means = np.empty((n_clusters, columns), dtype=np.int64)
        for j in range(n_clusters):
            block_id = rand.rand() % block_count
            cnt = min(MAX_LINES_PER_BLOCK, n - block_id * MAX_LINES_PER_BLOCK)
            line_id = rand.rand() % cnt
            if verbose:
                print(f"Chose block {block_id}, line {line_id}.")
            gidx = block_id * MAX_LINES_PER_BLOCK + line_id
            means[j] = _rows(mm, columns, gidx, gidx + 1)[0]
        assign = np.empty(n, dtype=np.uint8)
        iters = 0
        while iters < MAX_KMEANS_ITERATIONS:
            sums = np.zeros((n_clusters, columns), dtype=np.int64)
            cnts = np.zeros(n_clusters, dtype=np.int64)
            for lo in range(0, n, chunk_lines):
                hi = min(n, lo + chunk_lines)
                a, s_, c_ = rt.kmeans_iter(_rows(mm, columns, lo, hi),
                                           means)
                assign[lo:hi] = a
                sums += s_
                cnts += c_
            iters += 1
            new_means = sums // np.maximum(cnts, 1)[:, None]
            diff = (new_means - means).astype(np.float64)
            moved = float((diff * diff).sum(axis=1).max())
            if verbose:
                from qvz_tpu.spec import kmeans as spec_kmeans
                spec_kmeans.verbose_iteration(means, new_means)
            means = new_means
            if moved <= cluster_threshold:
                break
        if verbose:
            from qvz_tpu.spec import kmeans as spec_kmeans
            spec_kmeans.verbose_total(iters)
        stats["kmeans_iters"] = iters
    t1 = time.perf_counter()
    stats["cluster_s"] = t1 - t0

    if reuse_blocks is not None:
        # checkpoint path: codebooks fully determine the coder
        tables = rt.tables_from_blocks(reuse_blocks, n_clusters, columns)
        blocks = reuse_blocks[:tables.consumed]
        t2 = t3 = time.perf_counter()
        stats["stats_s"] = 0.0
        stats["design_s"] = t3 - t1
    else:
        # --- statistics (chunked, accumulated in place) ------------------
        counts0 = np.zeros((n_clusters, A), dtype=np.uint64)
        cond = np.zeros((n_clusters, columns - 1, A, A), dtype=np.uint64)
        for lo in range(0, n, chunk_lines):
            hi = min(n, lo + chunk_lines)
            if use_jax:
                # device histogram: the chunk uploads 1 B/symbol, the
                # returned count tensors are tiny (device-friendly even
                # on narrow links)
                from qvz_tpu.ops import stats as jx_stats
                c0j, cj = jx_stats.conditional_counts(
                    _rows(mm, columns, lo, hi),
                    assign[lo:hi] if assign is not None
                    else np.zeros(hi - lo, dtype=np.uint8), n_clusters)
                counts0 += np.asarray(c0j).astype(np.uint64)
                cond += np.asarray(cj).astype(np.uint64)
            else:
                rt.stats_host(_rows(mm, columns, lo, hi),
                              assign[lo:hi] if assign is not None
                              else None,
                              n_clusters, accumulate=(counts0, cond))
            if n_clusters == 1:
                # single-cluster: no later pass re-reads this range
                # until its own shard codes it; reclaim the pages
                _drop_pages(mm, columns, lo, hi)
        t2 = time.perf_counter()
        stats["stats_s"] = t2 - t1

        # --- design -------------------------------------------------------
        design = rt.Design(counts0, cond, mode, ratio, dist_matrix)
        blocks = design.serialized()
        tables = design.tables()
        t3 = time.perf_counter()
        stats["design_s"] = t3 - t2

    # --- shard plan + WELL states ----------------------------------------
    ncpu = os.cpu_count() or 1
    if shards == 0:
        shards = max(ncpu, -(-n // max_shard_lines))
    shards = max(1, min(shards, n))
    warmup = min(PRIME_WARMUP_LINES, max(8192, n // 12)) if prime else 0
    prime_on = warmup > 0 and shards > 1 and n > 2 * warmup
    counts = _shard_plan(n, columns, shards,
                         warmup=warmup if prime_on else 0)
    prime_on = prime_on and len(counts) > 1
    order = [(well_state.n + i) & 31 for i in range(32)]
    state_words = np.asarray(well_state.state, dtype=np.uint32)[order]
    if prime_on:
        base2 = rt.well_jump(state_words, 2, counts[0] * columns // 4)
        rest = rt.well_jump(base2[1], len(counts) - 1,
                            counts[1] * columns // 4)
        states = np.vstack([state_words[None, :], rest])
    else:
        states = rt.well_jump(state_words, len(counts),
                              counts[0] * columns // 4)
    offs = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    S = len(counts)

    # --- streaming container writer --------------------------------------
    # header + blocks + file state + directory placeholder, payloads
    # appended in shard order, directory backpatched at the end.
    head = container_v2._HEAD.pack(
        container_v2.MAGIC, container_v2.VERSION, n_clusters,
        container_v2.ORDER_COL, 1 if prime_on else 0, columns, n, S)
    dir_pos = len(head) + len(blocks) + 128
    dir_size = S * (container_v2._SHARD.size + 128)
    out_f = open(output_path, "wb")
    out_f.write(head)
    out_f.write(blocks)
    out_f.write(np.asarray(states[0], dtype="<u4").tobytes())
    out_f.write(b"\x00" * dir_size)

    payload_meta = [None] * S  # (length, checksum)
    pending = {}
    next_to_write = 0
    dist_total = 0.0

    # -u: shard workers write their reconstruction rows straight into a
    # memory-mapped text file; the OS flushes pages lazily, so RSS stays
    # at O(workers * shard) even at GB scale.
    recon_mm = None
    if recon_path is not None:
        recon_mm = np.memmap(recon_path, dtype=np.uint8, mode="w+",
                             shape=(n, columns + 1))

    def write_ready(s, payload):
        nonlocal next_to_write
        pending[s] = payload
        while next_to_write in pending:
            p = pending.pop(next_to_write)
            payload_meta[next_to_write] = (len(p), rt.xxh64(p))
            out_f.write(p)
            next_to_write += 1

    def code_shard(s, init_bank=None, want_bank=False):
        lo, hi = int(offs[s]), int(offs[s + 1])
        cl = assign[lo:hi] if assign is not None else None
        if use_jax:
            # device quantize (per-shard, bounded upload), host threads
            # advance the adaptive streams from the precomputed pairs —
            # the streaming form of _finish_encode's device-quantization
            # production path
            from qvz_tpu.ops import quantize as jx_quant
            rows = _rows(mm, columns, lo, hi)
            draws = rt.well_draws7(
                states[s], (hi - lo) * columns).reshape(hi - lo, columns)
            md_t, qs_t, qv_t = jx_quant.quantize_t(tables, rows, cl,
                                                   draws)
            out = rt.encode_precomputed_colmajor(
                tables, np.ascontiguousarray(md_t),
                np.ascontiguousarray(qs_t), cl, hi - lo,
                init_bank=init_bank, want_bank=want_bank)
            pay, bank_out = out if want_bank else (out, None)
            recon = qv_t.T if recon_mm is not None else None
            dsum = float(dist_matrix[rows.reshape(-1),
                                     qv_t.T.reshape(-1)].sum()) / columns
            del rows
            r = (pay, recon, dsum) + ((bank_out,) if want_bank else ())
        else:
            data_t = _rows_t(mm, columns, lo, hi)
            r = rt.encode_fused_colmajor(
                tables, data_t, cl,
                states[s], dist=dist_matrix,
                want_recon=recon_mm is not None,
                init_bank=init_bank, want_bank=want_bank)
            del data_t
        if recon_mm is not None:
            recon_mm[lo:hi, :columns] = r[1] + PHRED_OFFSET
            recon_mm[lo:hi, columns] = ord("\n")
            _flush_drop(recon_mm, columns + 1, lo, hi)
        _drop_pages(mm, columns, lo, hi)
        return r

    bank = None
    first = 0
    if prime_on:
        p0, _, d0, bank = code_shard(0, want_bank=True)
        dist_total += d0
        write_ready(0, p0)
        first = 1

    from threading import Lock
    wlock = Lock()

    def worker(s):
        nonlocal dist_total
        pay, _, dsum = code_shard(s, init_bank=bank)
        with wlock:
            write_ready(s, pay)
            dist_total += dsum

    with ThreadPoolExecutor(max_workers=ncpu) as ex:
        list(ex.map(worker, range(first, S)))
    assert next_to_write == S
    if recon_mm is not None:
        recon_mm.flush()
        del recon_mm

    # backpatch the directory
    out_f.seek(dir_pos)
    for s in range(S):
        plen, ck = payload_meta[s]
        out_f.write(container_v2._SHARD.pack(int(counts[s]), plen, ck))
        out_f.write(np.asarray(states[s], dtype="<u4").tobytes())
    out_f.close()
    t4 = time.perf_counter()
    stats["code_s"] = t4 - t3

    payload_bytes = sum(m[0] for m in payload_meta)
    stats["payload_bytes"] = payload_bytes
    stats["rate"] = payload_bytes * 8.0 / (float(n) * columns)
    stats["distortion"] = dist_total / n
    stats["total_s"] = t4 - t0
    stats["shards"] = S
    return stats
