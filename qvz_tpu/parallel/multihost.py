"""Multi-host driver: N processes, contiguous read ranges, one container.

The reference is one process, one thread (SURVEY §2b: no distributed
anything; the loop being distributed is src/qv_compressor.c:48-143).
This driver scales the QVZ2 pipeline across HOSTS — each host owns a
contiguous range of reads (whole shards), computes local integer
statistics, and codes its shards independently; the coordinator merges
statistics, designs codebooks once, broadcasts the serialized blocks,
and concatenates the shard directory in read order. Because every
cross-host reduction is an exact integer sum and every shard payload
depends only on (blocks, shard WELL start state, shard rows), the
container is byte-identical to the single-process QVZ2 encode for any
host count.

Deployment shapes:

  * This module (portable): one worker PROCESS per host, pipes for
    the tiny control-plane messages (centroids, count tensors, codebook
    blocks, payloads). It is the real driver for a multi-machine run
    launched under any process manager when each rank can read its
    slice of the input (shared FS / object store). Workers run the C++
    host engine only and never import JAX: a JAX process reserves most
    of an accelerator's memory when it first touches it, so a second
    worker on the same card would fail for want of memory. Accelerated
    multi-card runs use `encode(mesh=...)` in one process.
  * The collectives here (sum of count tensors, k-means accumulator
    merge) are deliberately the same integer reductions
    `parallel/sharded.py` runs as `psum` over a device mesh; multi-node
    runs move them to `jax.distributed` + psum over the global mesh
    without changing any downstream byte.

Phases (mirroring pipeline/encode.py):
  1. plan: shard plan + per-shard GF(2) WELL jump states (coordinator)
  2. k-means (optional): per-iteration local assignment + integer
     accumulators on each host, merged by the coordinator
     (cluster.c:212-243 semantics, bit-exact)
  3. statistics: local conditional histograms, integer-summed
  4. design: coordinator designs codebooks from the global counts
     (exact doubles, once), broadcasts serialized blocks
  5. coding: each host entropy-codes its shards (threads inside the
     host), ships payloads
  6. assembly: coordinator builds the QVZ2 container in read order
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import numpy as np

from qvz_tpu.constants import MODE_RATIO

# ---------------------------------------------------------------------------
# Worker process: owns rows [lo, hi) of the quality file.
#
# Workers are launched as fresh interpreters (subprocess + a
# multiprocessing.connection socket), NOT multiprocessing.Process: the
# spawn start method re-imports the parent's __main__ (breaks under
# pytest/stdin drivers), and fork after JAX initialization is
# unsafe. A fresh interpreter per host also mirrors the real
# multi-machine launch shape (one rank per host).


def _worker_main(port: int, path: str, lo: int, hi: int, columns: int,
                 recon_path: str | None = None,
                 chunk_lines: int = 0) -> None:
    """Subprocess entry: connect back to the coordinator and serve."""
    from multiprocessing.connection import Client

    authkey = bytes.fromhex(os.environ["QVZ_MH_AUTHKEY"])
    conn = Client(("127.0.0.1", port), authkey=authkey)
    _host_worker(conn, path, lo, hi, columns, recon_path, chunk_lines)


def _host_worker(conn, path: str, lo: int, hi: int, columns: int,
                 recon_path: str | None = None,
                 chunk_lines: int = 0) -> None:
    """One host. Owns rows [lo, hi); serves phase requests.

    chunk_lines == 0: the row range is materialized host-resident once
    (fastest when it fits). chunk_lines > 0: STREAMING worker — the
    range is never materialized; k-means and stats accumulate over
    chunk_lines-row passes of the memmap, coding materializes one
    shard per thread and drops its pages after, and shard payloads
    spill to a local file instead of crossing the control plane, so
    worker RSS is O(chunk + threads * shard) and the coordinator's is
    O(1) — a bounded-memory composition (the reference
    itself mmaps the whole file and is single-threaded, lines.c:64).
    """
    # Workers import numpy + the native runtime only, never JAX (see
    # the module docstring): keeps spawn cost low and the card free.
    import numpy as np

    from qvz_tpu.native import runtime as rt

    from qvz_tpu.constants import PHRED_OFFSET

    mm = np.memmap(path, dtype=np.uint8, mode="r")
    rows = mm.reshape(-1, columns + 1)[lo:hi, :columns]
    streaming = chunk_lines > 0
    if streaming:
        from qvz_tpu.pipeline.streaming import _drop_pages
        data = None
    else:
        # Phred+33 text -> symbol indices (codebook.c:200: char - 33),
        # identical uint8 wrap semantics to
        # spec.pipeline.load_quality_file; local copy, host-resident.
        data = np.ascontiguousarray(rows - PHRED_OFFSET)
    n_local = hi - lo

    def rows_sym(a: int, b: int) -> np.ndarray:
        """Local rows [a, b) as 0-based symbols (one chunk copy)."""
        if data is not None:
            return data[a:b]
        return np.ascontiguousarray(rows[a:b] - PHRED_OFFSET)

    def rows_sym_t(a: int, b: int) -> np.ndarray:
        """Local rows [a, b) column-major (one shard-sized buffer)."""
        if data is not None:
            return np.ascontiguousarray(data[a:b].T)
        dt = np.ascontiguousarray(rows[a:b].T)
        dt -= PHRED_OFFSET
        return dt

    def done_with(a: int, b: int) -> None:
        if streaming:
            _drop_pages(mm, columns, lo + a, lo + b)

    # Failure-injection hooks (chaos tests, tests/test_multihost.py):
    # the reference trusts every byte it reads (qv_compressor.c-era
    # trust is one of its bugs this framework fixes); these knobs let
    # tests prove the coordinator fails CLEAN — actionable error, no
    # partial container — when a worker dies or ships short payloads.
    chaos = os.environ.get("QVZ_MH_CHAOS", "")

    assign = None
    # -u under --hosts (reference writes the lossy reconstruction in
    # every encode mode, qv_compressor.c:100-103): each host writes its
    # reconstruction rows straight into the coordinator-presized text
    # file — shared-FS memmap, no bulk bytes over the control plane.
    recon_mm = None
    if recon_path is not None:
        recon_mm = np.memmap(recon_path, dtype=np.uint8,
                             mode="r+").reshape(-1, columns + 1)

    def put_recon(row0: int, recon: np.ndarray) -> None:
        dst = recon_mm[lo + row0: lo + row0 + len(recon)]
        dst[:, :columns] = recon + PHRED_OFFSET
        dst[:, columns] = ord("\n")

    while True:
        msg = conn.recv()
        cmd = msg[0]
        if cmd == "rows":
            # centroid seeding: fetch specific global rows we own
            idxs = msg[1]
            conn.send(np.stack([rows_sym(g - lo, g - lo + 1)[0]
                                for g in idxs]))
        elif cmd == "kmeans_iter":
            means = msg[1]
            if assign is None:
                assign = np.empty(n_local, dtype=np.uint8)
            if streaming:
                sums = np.zeros_like(means)
                counts = np.zeros(len(means), dtype=np.int64)
                for a in range(0, n_local, chunk_lines):
                    b = min(n_local, a + chunk_lines)
                    asg, s_, c_ = rt.kmeans_iter(rows_sym(a, b), means)
                    assign[a:b] = asg
                    sums += s_
                    counts += c_
            else:
                assign, sums, counts = rt.kmeans_iter(data, means)
            conn.send((sums, counts))
        elif cmd == "stats":
            n_clusters = msg[1]
            cl = assign if n_clusters > 1 else None
            if streaming:
                from qvz_tpu.constants import ALPHABET_SIZE as A
                c0 = np.zeros((n_clusters, A), dtype=np.uint64)
                cond = np.zeros((n_clusters, columns - 1, A, A),
                                dtype=np.uint64)
                for a in range(0, n_local, chunk_lines):
                    b = min(n_local, a + chunk_lines)
                    rt.stats_host(rows_sym(a, b),
                                  cl[a:b] if cl is not None else None,
                                  n_clusters, accumulate=(c0, cond))
                    if n_clusters == 1:
                        # single-cluster: nothing re-reads this range
                        # before its own shard codes it — release the
                        # pages (same policy as the single-process
                        # streaming pass; without this a worker's RSS
                        # grows to its whole slice: measured 6.45 GB
                        # on a 5.1 GB slice of the 100M-read corpus)
                        done_with(a, b)
            else:
                c0, cond = rt.stats_host(data, cl, n_clusters)
            conn.send((c0, cond))
        elif cmd == "encode_warmup":
            # prime source: encode ONLY the warmup shard (this host's
            # first), return its payload + the bank snapshot
            blocks, n_clusters, state0, count0, dist = msg[1:]
            tables = rt.tables_from_blocks(blocks, n_clusters, columns)
            out = rt.encode_fused_colmajor(
                tables, rows_sym_t(0, count0),
                assign[:count0] if assign is not None else None,
                state0, dist=dist, want_recon=recon_mm is not None,
                want_bank=True)
            pay, recon, dsum, bank = out
            if recon is not None:
                put_recon(0, recon)
            conn.send((pay, dsum, bank))
        elif cmd == "encode":
            if chaos == "die_on_encode" and lo > 0:
                os._exit(17)            # injected mid-phase worker death
            (blocks, n_clusters, states, counts, dist, skip0, bank,
             spill_path) = msg[1:]
            from concurrent.futures import ThreadPoolExecutor
            from threading import Lock

            tables = rt.tables_from_blocks(blocks, n_clusters, columns)
            offs = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
            S_loc = len(counts)
            # streaming: payloads land in the spill file in SHARD ORDER
            # (out-of-order completions buffer until their turn, bounded
            # by the thread count) so the coordinator can stream-copy
            # them straight into the container.
            spill_f = open(spill_path, "wb") if spill_path else None
            meta = [None] * S_loc
            pending = {}
            nxt = [skip0]
            wlock = Lock()

            def emit(s, pay, dsum):
                meta[s] = (len(pay), rt.xxh64(pay), float(dsum))
                if spill_f is None:
                    pending[s] = pay
                    return
                pending[s] = pay
                while nxt[0] in pending:
                    spill_f.write(pending.pop(nxt[0]))
                    nxt[0] += 1

            def run(s):
                a, b = int(offs[s]), int(offs[s + 1])
                pay, recon, dsum = rt.encode_fused_colmajor(
                    tables, rows_sym_t(a, b),
                    assign[a:b] if assign is not None else None,
                    states[s], dist=dist,
                    want_recon=recon_mm is not None,
                    init_bank=bank)
                if recon is not None:
                    put_recon(a, recon)
                done_with(a, b)
                with wlock:
                    emit(s, pay, dsum)

            todo = range(skip0, S_loc)
            with ThreadPoolExecutor(
                    max_workers=max(1, min(S_loc - skip0,
                                           os.cpu_count() or 1))) as ex:
                list(ex.map(run, todo))
            if recon_mm is not None:
                recon_mm.base.flush()
            dsum_total = float(sum(m[2] for m in meta[skip0:]))
            if spill_f is not None:
                spill_f.close()
                if chaos == "truncate_spill" and lo > 0:
                    # injected short payload: the directory metadata
                    # still claims the full size
                    with open(spill_path, "r+b") as tf:
                        tf.truncate(max(0,
                                        os.path.getsize(spill_path) - 64))
                conn.send(([(m[0], m[1]) for m in meta[skip0:]],
                           dsum_total))
            else:
                conn.send(([pending[s] for s in todo], dsum_total))
        elif cmd == "quit":
            conn.send(("bye",))
            return


def _decode_worker_main(port: int, container_path: str, out_path: str
                        ) -> None:
    """Subprocess entry for distributed decode: serve one batch of
    shards, pwriting decoded text into the (pre-sized) output file."""
    from multiprocessing.connection import Client

    import numpy as np

    from qvz_tpu.native import runtime as rt

    authkey = bytes.fromhex(os.environ["QVZ_MH_AUTHKEY"])
    conn = Client(("127.0.0.1", port), authkey=authkey)
    comp = np.memmap(container_path, dtype=np.uint8, mode="r")
    while True:
        msg = conn.recv()
        if msg[0] == "decode":
            (blocks, n_clusters, columns, order, metas, line_offs,
             bank) = msg[1:]
            from concurrent.futures import ThreadPoolExecutor

            from qvz_tpu.format import container_v2

            tables = rt.tables_from_blocks(blocks, n_clusters, columns)
            fd = os.open(out_path, os.O_WRONLY)

            def run(i):
                off, plen, nl, well, ck = metas[i]
                payload = bytes(comp[off:off + plen])
                if rt.xxh64(payload) != ck:
                    raise ValueError(f"shard checksum mismatch at {off}")
                # order dispatch mirrors pipeline.decode._decode_v2;
                # line-major shards never carry a primed bank (the
                # coordinator rejects priming + ORDER_LINE up front).
                if order == container_v2.ORDER_COL:
                    out = rt.decode_colmajor(
                        tables, payload, nl,
                        np.frombuffer(well, dtype="<u4"),
                        init_bank=bank)
                else:
                    out = rt.decode_lines(
                        tables, payload, nl,
                        np.frombuffer(well, dtype="<u4"))
                os.pwrite(fd, out.tobytes(),
                          line_offs[i] * (columns + 1))
                return nl

            try:
                with ThreadPoolExecutor(
                        max_workers=min(len(metas),
                                        os.cpu_count() or 1)) as ex:
                    done = list(ex.map(run, range(len(metas))))
                conn.send(("ok", int(sum(done))))
            finally:
                os.close(fd)
        elif msg[0] == "quit":
            conn.send(("bye",))
            return


# ---------------------------------------------------------------------------
# Coordinator.


def _accept_checked(listener, proc, timeout: float = 120.0):
    """listener.accept() that fails fast instead of hanging forever when
    the just-launched worker dies before connecting (import failure,
    OOM, bad PYTHONPATH). Waits for the listening socket to become
    readable in 1 s slices, checking the worker process in between."""
    import selectors

    sock = listener._listener._socket
    deadline = time.monotonic() + timeout
    with selectors.DefaultSelector() as sel:
        sel.register(sock, selectors.EVENT_READ)
        while True:
            if proc.poll() is not None:
                raise RuntimeError(
                    f"multihost worker exited with code {proc.returncode} "
                    "before connecting back")
            if sel.select(timeout=1.0):
                return listener.accept()
            if time.monotonic() > deadline:
                proc.kill()
                raise RuntimeError(
                    "timed out waiting for multihost worker to connect")


def _recv_checked(conn, proc, host: int, phase: str):
    """conn.recv() that converts a dead or wedged worker into an
    actionable coordinator error instead of a bare EOFError (or an
    indefinite hang). Polls the pipe in 1 s slices, checking the worker
    process in between; a worker that exited gets one 0.5 s grace poll
    to drain a message it sent just before dying."""
    while True:
        if conn.poll(1.0):
            try:
                return conn.recv()
            except (EOFError, OSError):
                raise RuntimeError(
                    f"multihost worker {host} closed its control pipe "
                    f"during {phase} (exit code {proc.poll()}); no "
                    "container was written") from None
        rc = proc.poll()
        if rc is not None:
            if conn.poll(0.5):
                try:
                    return conn.recv()
                except (EOFError, OSError):
                    pass
            raise RuntimeError(
                f"multihost worker {host} died during {phase} with exit "
                f"code {rc}; no container was written")


def _shard_plan(n: int, columns: int, shards: int, warmup: int = 0):
    from qvz_tpu.pipeline.encode import _shard_plan as plan
    return plan(n, columns, shards, warmup=warmup)


def encode_multihost(path: str, *, n_hosts: int, shards: int = 0,
                     n_clusters: int = 1, mode: int = MODE_RATIO,
                     ratio: float = 0.5, cluster_threshold: float = 4.0,
                     well_state=None, dist_matrix=None,
                     prime: bool = True,
                     recon_path: str | None = None,
                     verbose: bool = False,
                     streaming: bool = False,
                     chunk_lines: int = 1_000_000,
                     output_path: str | None = None):
    """Encode a quality file across n_hosts worker processes.

    Returns (container bytes, stats dict). The container is
    byte-identical to `pipeline.encode.encode(data, ..., shards=S)` for
    the same total shard count S — proven by tests/test_multihost.py.

    streaming=True (requires output_path): bounded-memory composition —
    workers stream their row ranges in
    chunk_lines passes instead of materializing them, shard payloads
    spill to per-host temp files, and the coordinator assembles the
    container straight to output_path (returns (None, stats)). Byte-
    identical to the non-streaming encode for the same shard plan;
    total RSS is O(hosts * (chunk + threads * shard)) regardless of
    corpus size, so --hosts N --streaming encodes a >RAM/host corpus.
    """
    from qvz_tpu.constants import MAX_KMEANS_ITERATIONS
    from qvz_tpu.format import container_v2
    from qvz_tpu.native import runtime as rt
    from qvz_tpu.ops.well import WellState
    from qvz_tpu.utils.glibc_rand import GlibcRand

    if well_state is None:
        well_state = WellState.debug()
    if dist_matrix is None:
        from qvz_tpu.constants import DISTORTION_MSE
        from qvz_tpu.ops.distortion import make_matrix
        dist_matrix = make_matrix(DISTORTION_MSE)

    # geometry from the file (lines.c:44-54 semantics)
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        first = f.readline()
    columns = len(first) - 1
    n = size // (columns + 1)

    if shards == 0:
        shards = max(n_hosts, (os.cpu_count() or 1))
        if streaming:
            # bounded-memory coding needs bounded shards (each worker
            # thread materializes one shard; 1M lines matches
            # pipeline/streaming.py's max_shard_lines default)
            shards = max(shards, -(-n // 1_000_000))
    from qvz_tpu.pipeline.encode import PRIME_WARMUP_LINES
    warmup = min(PRIME_WARMUP_LINES, max(8192, n // 12)) if prime else 0
    prime_on = warmup > 0 and shards > 1 and n > 2 * warmup
    counts = _shard_plan(n, columns, shards,
                         warmup=warmup if prime_on else 0)
    prime_on = prime_on and len(counts) > 1
    S = len(counts)
    n_hosts = max(1, min(n_hosts, S))

    # contiguous shard ranges per host
    host_shards = [(h * S // n_hosts, (h + 1) * S // n_hosts)
                   for h in range(n_hosts)]
    offs = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    t0 = time.perf_counter()

    # per-shard WELL start states (single logical dither stream)
    order = [(well_state.n + i) & 31 for i in range(32)]
    state_words = np.asarray(well_state.state, dtype=np.uint32)[order]
    if prime_on:
        base2 = rt.well_jump(state_words, 2, counts[0] * columns // 4)
        rest = rt.well_jump(base2[1], S - 1, counts[1] * columns // 4)
        states = np.vstack([state_words[None, :], rest])
    else:
        wpc = counts[0] * columns // 4
        states = rt.well_jump(state_words, S, wpc)

    from multiprocessing.connection import Listener

    authkey = os.urandom(16)
    listener = Listener(("127.0.0.1", 0), authkey=authkey)
    port = listener.address[1]
    env = dict(os.environ)
    env["QVZ_MH_AUTHKEY"] = authkey.hex()
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    if recon_path is not None:
        # presize the -u reconstruction file so workers can memmap r+
        # and write their row ranges in place (qv_compressor.c:100-103
        # writes it inline; here each host owns its slice)
        np.memmap(recon_path, dtype=np.uint8, mode="w+",
                  shape=(n, columns + 1)).flush()
    if streaming and output_path is None:
        raise ValueError("streaming multihost encode needs output_path")
    ck_lines = chunk_lines if streaming else 0
    conns, procs = [], []
    for h, (s0, s1) in enumerate(host_shards):
        code = ("from qvz_tpu.parallel.multihost import _worker_main; "
                f"_worker_main({port}, {path!r}, {int(offs[s0])}, "
                f"{int(offs[s1])}, {columns}, "
                f"{recon_path!r}, {ck_lines})")
        p = subprocess.Popen([sys.executable, "-c", code], env=env)
        procs.append(p)                  # conn h <-> host h
        conns.append(_accept_checked(listener, p))
    stats = {"hosts": n_hosts, "shards": S, "lines": n, "columns": columns}
    sdir = None

    try:
        # --- k-means (coordinator-merged integer accumulators) ----------
        if n_clusters > 1:
            # centroid seeds: exact reference draws (cluster.c:192-206)
            rand = GlibcRand(1)
            from qvz_tpu.constants import MAX_LINES_PER_BLOCK
            block_count = -(-n // MAX_LINES_PER_BLOCK)
            seed_idx = []
            for _ in range(n_clusters):
                block_id = rand.rand() % block_count
                cnt = min(MAX_LINES_PER_BLOCK,
                          n - block_id * MAX_LINES_PER_BLOCK)
                line_id = rand.rand() % cnt
                if verbose:
                    print(f"Chose block {block_id}, line {line_id}.")
                seed_idx.append(block_id * MAX_LINES_PER_BLOCK + line_id)
            means = np.empty((n_clusters, columns), dtype=np.int64)
            for j, gidx in enumerate(seed_idx):
                h = next(i for i, (s0, s1) in enumerate(host_shards)
                         if offs[s0] <= gidx < offs[s1])
                conns[h].send(("rows", [gidx]))
                means[j] = _recv_checked(conns[h], procs[h], h,
                                         "k-means seeding")[0]
            iters = 0
            while iters < MAX_KMEANS_ITERATIONS:
                for c in conns:
                    c.send(("kmeans_iter", means))
                sums = np.zeros((n_clusters, columns), dtype=np.int64)
                cnts = np.zeros(n_clusters, dtype=np.int64)
                for hh, c in enumerate(conns):
                    s_, c_ = _recv_checked(c, procs[hh], hh,
                                           "k-means iteration")
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

        # --- statistics (integer-summed across hosts) -------------------
        for c in conns:
            c.send(("stats", n_clusters))
        c0_sum = cond_sum = None
        for hh, c in enumerate(conns):
            c0, cond = _recv_checked(c, procs[hh], hh, "statistics")
            if c0_sum is None:
                c0_sum, cond_sum = c0.copy(), cond.copy()
            else:
                c0_sum += c0
                cond_sum += cond
        t2 = time.perf_counter()
        stats["stats_s"] = t2 - t1

        # --- design (once, on the coordinator) --------------------------
        design = rt.Design(np.asarray(c0_sum), np.asarray(cond_sum),
                           mode, ratio, dist_matrix)
        blocks = design.serialized()
        t3 = time.perf_counter()
        stats["design_s"] = t3 - t2

        # --- coding (each host codes its shards) ------------------------
        # With priming, host 0 first encodes the warmup shard alone and
        # the captured bank snapshot is broadcast to every host — the
        # cross-host analog of the in-process warmup stage.
        dist_total = 0.0
        warm_pay = None
        bank = None
        if prime_on:
            conns[0].send(("encode_warmup", blocks, n_clusters,
                           states[0], int(counts[0]), dist_matrix))
            warm_pay, dsum0, bank = _recv_checked(
                conns[0], procs[0], 0, "warmup encode")
            dist_total += dsum0
        spills = [None] * n_hosts
        if streaming:
            import tempfile
            sdir = tempfile.mkdtemp(prefix="qvz_mh_spill_",
                                    dir=os.path.dirname(
                                        os.path.abspath(output_path))
                                    or None)
            spills = [os.path.join(sdir, f"host{h}.pay")
                      for h in range(n_hosts)]
        payload_lists = [None] * n_hosts
        for h, (s0, s1) in enumerate(host_shards):
            skip0 = 1 if (prime_on and h == 0) else 0
            conns[h].send(("encode", blocks, n_clusters,
                           states[s0:s1], counts[s0:s1], dist_matrix,
                           skip0, bank, spills[h]))
        for h, c in enumerate(conns):
            payloads, dsum = _recv_checked(c, procs[h], h, "coding")
            payload_lists[h] = payloads
            dist_total += dsum
        t4 = time.perf_counter()
        stats["code_s"] = t4 - t3

        if streaming:
            # assemble straight to disk: header + blocks + file state +
            # directory (sizes/checksums now known) + warmup payload +
            # per-host spill files, byte-identical to container_v2.build
            metas = []
            if prime_on:
                metas.append((len(warm_pay), rt.xxh64(warm_pay)))
            for lst in payload_lists:
                metas.extend(lst)
            assert len(metas) == S
            # fail CLEAN before the container exists: every spill file
            # must hold exactly the bytes its host's directory entries
            # claim — a worker that crashed after reporting, ran out of
            # disk, or shipped a short payload is caught here, not by
            # the eventual decoder's checksums
            mi = 1 if prime_on else 0
            for h, (s0, s1) in enumerate(host_shards):
                lst = payload_lists[h]
                want = sum(m[0] for m in lst)
                got = os.path.getsize(spills[h])
                mi += len(lst)
                if got != want:
                    raise ValueError(
                        f"multihost worker {h} spill file holds {got} "
                        f"payload bytes but its shard directory entries "
                        f"claim {want} — truncated/corrupt payload; no "
                        "container was written")
            head = container_v2._HEAD.pack(
                container_v2.MAGIC, container_v2.VERSION, n_clusters,
                container_v2.ORDER_COL, 1 if prime_on else 0,
                columns, n, S)
            try:
                with open(output_path, "wb") as out_f:
                    out_f.write(head)
                    out_f.write(blocks)
                    out_f.write(np.asarray(states[0],
                                           dtype="<u4").tobytes())
                    for s in range(S):
                        plen, ck = metas[s]
                        out_f.write(container_v2._SHARD.pack(
                            int(counts[s]), plen, ck))
                        out_f.write(np.asarray(states[s],
                                               dtype="<u4").tobytes())
                    if prime_on:
                        out_f.write(warm_pay)
                    import shutil as _sh
                    for h in range(n_hosts):
                        with open(spills[h], "rb") as sf:
                            _sh.copyfileobj(sf, out_f, 16 * 2 ** 20)
                        os.unlink(spills[h])
            except BaseException:
                # never leave a partial container behind
                try:
                    os.unlink(output_path)
                except OSError:
                    pass
                raise
            os.rmdir(sdir)
            compressed = None
            payload_bytes = sum(m[0] for m in metas)
        else:
            if prime_on:
                payload_lists[0] = [warm_pay] + payload_lists[0]
            all_payloads = [p for lst in payload_lists for p in lst]
            shard_states = [np.asarray(states[s], dtype="<u4").tobytes()
                            for s in range(S)]
            compressed = container_v2.build(
                blocks, n_clusters, columns, n, counts, shard_states,
                all_payloads, priming=1 if prime_on else 0)
            payload_bytes = sum(len(p) for p in all_payloads)
        stats["payload_bytes"] = payload_bytes
        stats["rate"] = payload_bytes * 8.0 / (float(n) * columns)
        stats["distortion"] = dist_total / n
        stats["total_s"] = time.perf_counter() - t0
        return compressed, stats
    finally:
        if sdir is not None and os.path.isdir(sdir):
            import shutil as _sh
            _sh.rmtree(sdir, ignore_errors=True)
        for c in conns:
            try:
                c.send(("quit",))
                if c.poll(10):
                    c.recv()
            except Exception:
                pass
        listener.close()
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()


def decode_multihost(container_path: str, out_path: str, *,
                     n_hosts: int) -> int:
    """Distributed decode: N worker processes decode contiguous shard
    ranges of a QVZ2 container, each pwriting its slice of the output
    file. Byte-identical to the single-process decode. Returns lines.

    With priming, the coordinator decodes the warmup shard first (the
    serial stage) and broadcasts the captured bank to all workers."""
    from multiprocessing.connection import Listener

    import numpy as np

    from qvz_tpu.format import container_v2
    from qvz_tpu.native import runtime as rt

    comp = np.memmap(container_path, dtype=np.uint8, mode="r")
    head_bytes = bytes(comp[:1 << 20]) if comp.size > (1 << 20) else \
        bytes(comp)
    if not container_v2.is_v2(head_bytes):
        raise ValueError("decode_multihost requires a QVZ2 container")
    head = container_v2.parse(head_bytes, blocks_len=None)
    tables = rt.tables_from_blocks(
        head_bytes[container_v2.header_size():], head.cluster_count,
        head.columns)
    # The directory fits in the first MB for any sane shard count;
    # payload extents are validated against the real file size
    # (payload_limit) so the prefix parse succeeds without copying the
    # whole container into memory. Fall back to a full read only when
    # the directory itself overflows the prefix.
    try:
        head = container_v2.parse(head_bytes, blocks_len=tables.consumed,
                                  payload_limit=comp.size)
    except ValueError:
        head = container_v2.parse(bytes(comp), blocks_len=tables.consumed)
    cols = head.columns
    n = head.lines
    if head.priming and head.order != container_v2.ORDER_COL:
        raise ValueError("primed QVZ2 requires column-major order")

    # pre-size the output file
    with open(out_path, "wb") as f:
        f.truncate(n * (cols + 1))

    line_offs = np.concatenate(
        [[0], np.cumsum([s.lines for s in head.shards])]).astype(np.int64)
    blocks = bytes(head.blocks)

    bank = None
    first = 0
    if head.priming and len(head.shards) > 1:
        s0 = head.shards[0]
        payload = bytes(comp[s0.payload_off:s0.payload_off
                             + s0.payload_len])
        if rt.xxh64(payload) != s0.checksum:
            raise ValueError("warmup shard checksum mismatch")
        out0, bank = rt.decode_colmajor(
            tables, payload, s0.lines,
            np.frombuffer(s0.well_state, dtype="<u4"), want_bank=True)
        with open(out_path, "r+b") as f:
            f.write(out0.tobytes())
        first = 1

    todo = list(range(first, len(head.shards)))
    n_hosts = max(1, min(n_hosts, len(todo) or 1))
    if todo:
        authkey = os.urandom(16)
        listener = Listener(("127.0.0.1", 0), authkey=authkey)
        port = listener.address[1]
        env = dict(os.environ)
        env["QVZ_MH_AUTHKEY"] = authkey.hex()
        repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env["PYTHONPATH"] = repo_root + os.pathsep + env.get(
            "PYTHONPATH", "")
        conns, procs = [], []
        ranges = [todo[h * len(todo) // n_hosts:
                       (h + 1) * len(todo) // n_hosts]
                  for h in range(n_hosts)]
        try:
            for h in range(n_hosts):
                code = ("from qvz_tpu.parallel.multihost import "
                        "_decode_worker_main; _decode_worker_main("
                        f"{port}, {container_path!r}, {out_path!r})")
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", code], env=env))
                conns.append(_accept_checked(listener, procs[-1]))
            for h, idxs in enumerate(ranges):
                metas = [(head.shards[i].payload_off,
                          head.shards[i].payload_len,
                          head.shards[i].lines,
                          head.shards[i].well_state,
                          head.shards[i].checksum) for i in idxs]
                conns[h].send(("decode", blocks, head.cluster_count,
                               cols, head.order, metas,
                               [int(line_offs[i]) for i in idxs], bank))
            total = 0
            for c in conns:
                status, nl = c.recv()
                assert status == "ok"
                total += nl
        finally:
            for c in conns:
                try:
                    c.send(("quit",))
                    c.recv()
                except Exception:
                    pass
            listener.close()
            for p in procs:
                try:
                    p.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    p.kill()
    return n
