"""Production decoder pipeline (reference: src/main.c:132-160).

Decoding is inherently sequential (each symbol's context depends on the
previously decoded symbol and the shared adaptive-model state), so the
whole pass runs in the native C++ runtime after the container header and
codebook tables are parsed.
"""

from __future__ import annotations

import contextlib
import functools
import struct

import numpy as np

from qvz_tpu.format import container, container_v2
from qvz_tpu.native import runtime as rt


def _malformed_raises_valueerror(fn):
    """Error-type convergence at the decode boundary: a malformed or
    hostile container must always surface as ValueError, whatever the
    parsing internals tripped over (short-buffer slicing, struct
    unpacking). The reference has no validation at all
    (codebook.c:560-586 trusts every byte); converging on one exception
    type is what makes ours testable and catchable.

    MemoryError/OverflowError are NOT converted here: a
    host OOM while decoding a large, VALID container is a resource
    failure, not corruption, and must surface as MemoryError. Those two
    are converted only inside `_parsing()` blocks, where absurd claimed
    sizes from a hostile header are the plausible cause."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        try:
            return fn(*args, **kwargs)
        except (IndexError, struct.error) as e:
            raise ValueError(
                f"malformed container ({type(e).__name__}: {e})") from e
    return wrapper


@contextlib.contextmanager
def _parsing():
    """Header/geometry/table parsing stage: here an OverflowError (ctypes
    width conversion) or MemoryError (allocator fed a hostile claimed
    size) IS evidence of a malformed container."""
    try:
        yield
    except (IndexError, OverflowError, MemoryError, struct.error) as e:
        raise ValueError(
            f"malformed container ({type(e).__name__}: {e})") from e


def _sane_output_size(lines: int, columns: int) -> None:
    """Corrupt headers can claim absurd geometry; decoding then costs
    O(lines) even when the payload is tiny (the reference has the same
    blind spot — it trusts its header, main.c:150). Cap the claimed
    output size (default 1 TB, QVZ_TPU_MAX_DECODE_BYTES overrides)."""
    import os

    cap = int(os.environ.get("QVZ_TPU_MAX_DECODE_BYTES", 1 << 40))
    if lines * (columns + 1) > cap:
        raise ValueError(
            f"container claims {lines}x{columns} output "
            f"(> {cap} bytes); refusing (set QVZ_TPU_MAX_DECODE_BYTES "
            f"to raise)")


@_malformed_raises_valueerror
def decode(compressed: bytes, out: np.ndarray | None = None,
           verbose: bool = False,
           device: bool | None = None) -> np.ndarray:
    """Decode a container to Phred+33 text bytes (N, cols+1) w/ newlines.

    Accepts both the reference-compatible v1 container and the sharded
    QVZ2 container (decoded with one host thread per shard). `out` may
    be a preallocated (lines, cols+1) uint8 buffer — e.g. an np.memmap —
    written in place.

    device=True routes column-major QVZ2 shards through the lane-
    parallel accelerator decoder (ops/decoder_device.py); lanes its
    exactness checks flag are re-decoded on host, so output equals the
    host decoder's bytes unconditionally. Default: the
    QVZ_TPU_DEVICE_DECODE env knob (off)."""
    if device is None:
        import os
        device = os.environ.get("QVZ_TPU_DEVICE_DECODE", "0") == "1"
    if container_v2.is_v2(compressed):
        return _decode_v2(compressed, out, device=device)
    with _parsing():
        cluster_count, columns, lines = container.read_header(
            compressed[:9])
        _sane_output_size(lines, columns)
        tables = rt.tables_from_blocks(compressed[9:], cluster_count,
                                       columns)
    pos = 9 + tables.consumed
    well_words = np.frombuffer(compressed[pos:pos + 128], dtype="<u4")
    payload = compressed[pos + 128:]
    return rt.decode_lines(
        tables, payload, lines, well_words,
        out=out.reshape(-1) if out is not None else None,
        verbose=verbose)


def _decode_v2(compressed: bytes, out: np.ndarray | None = None,
               device: bool = False) -> np.ndarray:
    import os
    from concurrent.futures import ThreadPoolExecutor

    with _parsing():
        head = container_v2.parse(compressed, blocks_len=None)
        hdr = container_v2.header_size()
        tables = rt.tables_from_blocks(compressed[hdr:],
                                       head.cluster_count, head.columns)
        head = container_v2.parse(compressed, blocks_len=tables.consumed)
        cols = head.columns
        _sane_output_size(head.lines, cols)
    if out is None:
        out = np.empty((head.lines, cols + 1), dtype=np.uint8)
    offs = np.concatenate(
        [[0], np.cumsum([s.lines for s in head.shards])]).astype(np.int64)

    if (device and head.order == container_v2.ORDER_COL
            and len(head.shards) >= 2):
        return _decode_v2_device(compressed, head, tables, out, offs)

    dec_fn = (rt.decode_colmajor if head.order == container_v2.ORDER_COL
              else rt.decode_lines)

    def _writeback(i):
        # memmap output (decode_to_file): msync + release the shard's
        # rows so a whole-genome decode's dirty pages don't pile up in
        # the resident set until the final flush (measured 11.9 GB
        # peak RSS on a 10.2 GB decode without this; 1.9 GB with)
        if isinstance(out, np.memmap):
            from qvz_tpu.pipeline.streaming import _flush_drop
            _flush_drop(out, cols + 1, int(offs[i]), int(offs[i + 1]))

    def run(i, init_bank=None, want_bank=False, draws_t=None):
        s = head.shards[i]
        well = np.frombuffer(s.well_state, dtype="<u4")
        payload = compressed[s.payload_off:s.payload_off + s.payload_len]
        if rt.xxh64(payload) != s.checksum:
            raise ValueError(
                f"shard {i} payload checksum mismatch (corrupt container)")
        if init_bank is not None or want_bank or draws_t is not None:
            if head.order != container_v2.ORDER_COL:
                raise ValueError("primed QVZ2 requires column-major order")
            r = rt.decode_colmajor(
                tables, payload, s.lines, well,
                out=out[offs[i]:offs[i + 1]].reshape(-1),
                init_bank=init_bank, want_bank=want_bank, draws_t=draws_t)
            _writeback(i)
            return r
        dec_fn(tables, payload, s.lines, well,
               out=out[offs[i]:offs[i + 1]].reshape(-1))
        _writeback(i)

    if head.priming and len(head.shards) > 1:
        # Primed container: shard 0's decode is a serial stage (it
        # derives the shared prior). Overlap it with the OTHER shards'
        # dither-draw generation + transpose (checksum verify rides
        # along) — that work only needs each shard's WELL start state.
        from threading import Event, Thread

        bank_box = {}
        ready = Event()

        def warmup():
            # ready is set even on failure — otherwise every worker
            # blocks forever in ready.wait() and decode() hangs instead
            # of surfacing the (e.g. checksum) error
            try:
                _, bank_box["bank"] = run(0, want_bank=True)
            except BaseException as e:
                bank_box["err"] = e
            finally:
                ready.set()

        wt = Thread(target=warmup)
        wt.start()

        def prep_and_decode(i):
            s = head.shards[i]
            well = np.frombuffer(s.well_state, dtype="<u4")
            draws_t = np.ascontiguousarray(rt.well_draws7(
                well, s.lines * cols).reshape(s.lines, cols).T)
            ready.wait()
            if "err" in bank_box:
                return None  # warmup failed; re-raised below
            return run(i, init_bank=bank_box["bank"], draws_t=draws_t)

        with ThreadPoolExecutor(
                max_workers=min(len(head.shards) - 1,
                                os.cpu_count() or 1)) as ex:
            list(ex.map(prep_and_decode, range(1, len(head.shards))))
        wt.join()
        if "err" in bank_box:
            raise bank_box["err"]
    else:
        with ThreadPoolExecutor(
                max_workers=min(len(head.shards),
                                os.cpu_count() or 1)) as ex:
            list(ex.map(run, range(len(head.shards))))
    return out


def _decode_v2_device(compressed, head, tables, out, offs) -> np.ndarray:
    """Lane-parallel QVZ2 decode on the accelerator (the decode twin of
    pipeline/encode._device_coder_encode; kernel in
    ops/decoder_device.py).

    The warmup shard (when primed) decodes on host — it derives the
    shared prior and is the one serial stage. Every other shard becomes
    a device lane, grouped by line count (equal-length lanes advance in
    lockstep). Cluster-id segments (model 0, the one model that can
    legitimately rescale) are decoded by a tiny host prologue that also
    pins the exact coder state where each lane's scan takes over.
    Flagged lanes (rescaling column model / tag escape) re-decode on
    host, so the output is byte-identical to the host decoder always."""
    from concurrent.futures import ThreadPoolExecutor

    from qvz_tpu.ops.coder_device import FULL, LanePlan
    from qvz_tpu.ops.decoder_device import DecodePlan, decode_lanes

    cols = head.columns
    shards = head.shards

    def payload_of(i):
        s = shards[i]
        pay = compressed[s.payload_off:s.payload_off + s.payload_len]
        if rt.xxh64(pay) != s.checksum:
            raise ValueError(
                f"shard {i} payload checksum mismatch (corrupt container)")
        return bytes(pay)

    first = 0
    bank = None
    warmup = None
    bank_box: dict = {}
    if head.priming and len(shards) > 1:
        # the warmup decode is the one serial stage; overlap it with
        # the lane prep that does not need its bank (checksums + WELL
        # draw generation — the cluster prologue DOES need the bank
        # and runs after the join)
        from threading import Thread

        def _warmup():
            try:
                s0 = shards[0]
                well0 = np.frombuffer(s0.well_state, dtype="<u4")
                _, bank_box["bank"] = rt.decode_colmajor(
                    tables, payload_of(0), s0.lines, well0,
                    out=out[offs[0]:offs[1]].reshape(-1),
                    want_bank=True)
            except BaseException as e:  # re-raised on the caller thread
                bank_box["err"] = e

        warmup = Thread(target=_warmup)
        warmup.start()
        first = 1

    groups: dict[int, list[int]] = {}
    for i in range(first, len(shards)):
        groups.setdefault(shards[i].lines, []).append(i)

    def prep_a(i):
        s = shards[i]
        pay = payload_of(i)
        well = np.frombuffer(s.well_state, dtype="<u4")
        draws_t = np.ascontiguousarray(rt.well_draws7(
            well, s.lines * cols).reshape(s.lines, cols).T)
        return pay, draws_t

    def prep_b(args):
        i, pay = args
        s = shards[i]
        if head.cluster_count > 1:
            cl, l0, u0, t0, bp = rt.decode_cluster_prologue(
                tables, pay, s.lines, init_bank=bank)
            return cl, (l0, u0, t0, bp)
        w0 = int(np.frombuffer(pay[:4].ljust(4, b"\0"),
                               dtype=">u4")[0])
        return (np.zeros(s.lines, dtype=np.uint8),
                (0, int(FULL), w0 >> 10, 22))

    import os as _os

    # lanes decode in waves of ~2^28 symbols: bounds host and device
    # memory for the per-shard draw matrices (a whole-genome
    # container's draws are the full quality matrix) and keeps the jit
    # cache on one (W, L) shape per group; QVZ_TPU_DEC_WAVE overrides
    # the lanes per wave
    wave = int(_os.environ.get("QVZ_TPU_DEC_WAVE", "0"))
    fallback: list[tuple[int, bytes]] = []
    dplan = None
    with ThreadPoolExecutor(
            max_workers=min(8, _os.cpu_count() or 1)) as ex:
        for L, idxs in groups.items():
            lanes = wave or max(1, (1 << 28) // (L * cols))
            for w0i in range(0, len(idxs), lanes):
                wv = idxs[w0i:w0i + lanes]
                pa = list(ex.map(prep_a, wv))
                if dplan is None:
                    # first wave's prep overlapped the warmup decode
                    if warmup is not None:
                        warmup.join()
                        if "err" in bank_box:
                            raise bank_box["err"]
                        bank = bank_box["bank"]
                    plan = LanePlan(tables, bank)
                    dplan = DecodePlan(plan, tables)
                payloads = [p[0] for p in pa]
                draws = np.stack([p[1] for p in pa], axis=1)
                pb = list(ex.map(prep_b, zip(wv, payloads)))
                cl = np.stack([p[0] for p in pb], axis=0)
                states = [p[1] for p in pb]
                qv, flags = decode_lanes(dplan, payloads, draws, cl,
                                         states)
                for w, i in enumerate(wv):
                    if flags[w]:
                        fallback.append((i, payloads[w]))
                        continue
                    dst = out[offs[i]:offs[i + 1]]
                    dst[:, :cols] = qv[w] + 33
                    dst[:, cols] = ord("\n")

        def host_redecode(args):
            i, pay = args
            s = shards[i]
            well = np.frombuffer(s.well_state, dtype="<u4")
            rt.decode_colmajor(tables, pay, s.lines, well,
                               out=out[offs[i]:offs[i + 1]].reshape(-1),
                               init_bank=bank)

        # flagged lanes re-decode on host THREADS (checksums already
        # verified in prep_a), matching the plain host path's
        # parallelism when the exactness checks punt every lane
        list(ex.map(host_redecode, fallback))
    return out


@_malformed_raises_valueerror
def decode_to_file(compressed, path: str, verbose: bool = False,
                   device: bool | None = None) -> int:
    """Decode straight into a memory-mapped output file: shard threads
    write their line ranges in place and the OS flushes pages lazily —
    no second full-size copy at GB scale. `compressed` may be bytes or
    any buffer (e.g. an np.memmap of the container — see
    decode_file_to_file)."""
    with _parsing():
        if container_v2.is_v2(compressed):
            head = container_v2.parse(compressed, blocks_len=None)
            lines, cols = head.lines, head.columns
        else:
            _, cols, lines = container.read_header(bytes(compressed[:9]))
    if lines == 0:
        open(path, "wb").close()
        return 0
    _sane_output_size(lines, cols)
    mm = np.memmap(path, dtype=np.uint8, mode="w+",
                   shape=(lines, cols + 1))
    decode(compressed, out=mm, verbose=verbose, device=device)
    mm.flush()
    return lines


def decode_file_to_file(in_path: str, out_path: str,
                        verbose: bool = False,
                        device: bool | None = None) -> int:
    """Decode a container FILE without reading it into memory: the
    container is memory-mapped and shard payloads are sliced zero-copy
    (a whole-genome-scale QVZ2 container is tens of GB — reading it
    up front would double peak memory for no reason)."""
    import os

    if os.path.getsize(in_path) == 0:
        raise ValueError("empty container")
    mm_in = np.memmap(in_path, dtype=np.uint8, mode="r")
    return decode_to_file(mm_in, out_path, verbose=verbose,
                          device=device)
