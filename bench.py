#!/usr/bin/env python
"""End-to-end benchmark: qvz_tpu vs reference qvz, plus the device legs.

Measures wall-clock encode+decode throughput through the public pipeline
API on a deterministic synthetic 500k x 100 Illumina-like quality file,
single cluster, -f 0.5 (the reference's default operating mode). The
baseline is the OPTIMIZED (-O3) reference build measured live on the
same machine when the reference source tree (BASELINE.json
`reference_path`) is present, else the embedded numbers recorded on
the development host (encode 20.96 s, decode 4.76 s for the same file
=> 3.93 MB/s combined).

Needs a GPU: the device legs (forced device encode and device decode,
each byte-checked against the host engine) and the per-kernel timings
run on it, in this process. No GPU, or a device leg that fails, fails
the run.

Prints ONE JSON line:
  {"metric": ..., "value": MB/s, "unit": "MB/s", "vs_baseline": x}

Throughput accounting: (uncompressed bytes in + uncompressed bytes out)
/ (encode seconds + decode seconds); rate/distortion parity is asserted
(our -s stats must match the reference operating point) so the speed
number can't be bought with a broken codec.
"""

from __future__ import annotations

import json
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time

REPO = pathlib.Path(__file__).resolve().parent
REFERENCE_SRC = pathlib.Path(json.loads(
    (REPO / "BASELINE.json").read_text())["reference_path"])
N_LINES = 500_000
COLS = 100

# Embedded fallback baseline (optimized reference, development host).
FALLBACK_REF_ENCODE_S = 20.96
FALLBACK_REF_DECODE_S = 4.76


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def make_input(path: pathlib.Path) -> int:
    import numpy as np
    rng = np.random.default_rng(7)
    start = rng.integers(28, 40, size=(N_LINES, 1))
    steps = (rng.integers(-2, 3, size=(N_LINES, COLS - 1))
             - (np.arange(COLS - 1) // 40))
    q = np.clip(np.concatenate([start, steps], 1).cumsum(1), 2, 41)
    out = np.empty((N_LINES, COLS + 1), dtype=np.uint8)
    out[:, :COLS] = q.astype(np.uint8) + 33
    out[:, COLS] = 10
    path.write_bytes(out.tobytes())
    return out.nbytes


def build_reference(tmp: pathlib.Path) -> pathlib.Path | None:
    if not REFERENCE_SRC.is_dir():
        return None
    ref = tmp / "refopt"
    shutil.copytree(REFERENCE_SRC, ref)
    r = subprocess.run(["make"], cwd=ref, capture_output=True)
    binary = ref / "bin" / "qvz"
    if r.returncode != 0 or not binary.exists():
        return None
    return binary


def timed(cmd: list[str]) -> tuple[float, subprocess.CompletedProcess]:
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True)
    dt = time.perf_counter() - t0
    if r.returncode != 0:
        log(f"FAILED: {' '.join(cmd)}\n{r.stdout}\n{r.stderr}")
        sys.exit(1)
    return dt, r


def stats_line(out: str) -> dict:
    # "rate, R, distortion, D, time, T, size, S"
    for line in out.splitlines():
        if line.startswith("rate,"):
            f = [x.strip() for x in line.split(",")]
            return {"rate": float(f[1]), "distortion": float(f[3]),
                    "size": int(f[7])}
    return {}


def device_kernels(data, telemetry: dict) -> None:
    """Steady-state device times of the stats and k-means forms on the
    bench input, with their share of the card's published peaks."""
    import jax
    import jax.numpy as jnp

    from qvz_tpu.ops.kmeans import _kmeans_step
    from qvz_tpu.ops.stats import _hist_device
    from qvz_tpu.utils import roofline as rl

    def best_ms(f, reps=10):
        jax.block_until_ready(f())
        best = 1e9
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(f())
            best = min(best, time.perf_counter() - t0)
        return best * 1e3

    n, cols = data.shape
    dd = jax.device_put(data)
    cl = jnp.zeros(n, jnp.uint8)
    means = jnp.asarray(data[:4], jnp.int32)
    telemetry["hist_ms"] = round(best_ms(
        lambda: _hist_device(dd, cl, 1)), 3)
    telemetry["kmeans_ms"] = round(best_ms(
        lambda: _kmeans_step(dd, means, 4)), 3)
    peaks = rl.peaks_for(jax.devices()[0].device_kind)
    telemetry["utilization"] = {
        "hist": rl.utilization(rl.hist_bytes(n, cols, 1),
                               telemetry["hist_ms"] / 1e3, peaks),
        "kmeans": rl.utilization(rl.kmeans_bytes(n, cols, 4),
                                 telemetry["kmeans_ms"] / 1e3, peaks),
    }
    log(f"device/hist: {telemetry['hist_ms']} ms, device/kmeans: "
        f"{telemetry['kmeans_ms']} ms per {n} x {cols} pass "
        f"(steady-state, device-resident)")


def main() -> None:
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="qvz_bench_"))
    try:
        inp = tmp / "bench.in"
        nbytes = make_input(inp)
        mb = nbytes / 1e6
        log(f"input: {N_LINES} lines x {COLS} cols = {mb:.1f} MB")

        # --- ours: in-process through the public pipeline API. Python
        # interpreter startup is excluded — a production service is a
        # long-lived process. File IO and container assembly ARE inside
        # the timed region.
        sys.path.insert(0, str(REPO))
        import jax

        from qvz_tpu.constants import DISTORTION_MSE
        import qvz_tpu.native
        from qvz_tpu.utils.compile_cache import enable_compile_cache
        enable_compile_cache()
        qvz_tpu.native.load()  # compile the C++ runtime outside the timer
        from qvz_tpu.ops.distortion import make_matrix
        from qvz_tpu.ops.well import WellState
        from qvz_tpu.pipeline import decode as dec_mod
        from qvz_tpu.pipeline import encode as enc_mod
        from qvz_tpu.spec.pipeline import load_quality_file

        if jax.default_backend() != "gpu":
            log(f"FATAL: no GPU (JAX backend {jax.default_backend()})")
            sys.exit(1)
        dev0 = jax.devices()[0]
        telemetry: dict = {"device": {"platform": dev0.platform,
                                      "kind": dev0.device_kind,
                                      "count": len(jax.devices())}}

        our_q, our_dec = tmp / "our.q", tmp / "our.dec"
        dist = make_matrix(DISTORTION_MSE)

        def run_mode(shards, use_jax=False):
            t0 = time.perf_counter()
            data = load_quality_file(str(inp))
            out = enc_mod.encode(data, dist, n_clusters=1, ratio=0.5,
                                 well_state=WellState.debug(),
                                 shards=shards, want_recon=False,
                                 use_jax=use_jax)
            our_q.write_bytes(out.compressed)
            te = time.perf_counter() - t0
            t0 = time.perf_counter()
            dec_mod.decode_to_file(our_q.read_bytes(), str(our_dec))
            td = time.perf_counter() - t0
            return te, td, out

        # v1 reference-format parity mode (one sequential stream)
        p_enc, p_dec, p_out = run_mode(1)
        log(f"ours/parity-v1: encode {p_enc:.2f}s decode {p_dec:.2f}s "
            f"rate {p_out.stats.rate:.4f} distortion "
            f"{p_out.stats.distortion:.4f}")

        # production sharded mode (QVZ2, one stream per CPU): identical
        # reconstruction, independently decodable parallel streams.
        # Best-of-5 to damp noisy-neighbor variance on shared hosts.
        enc_samples, dec_samples = [], []
        t_enc, t_dec, s_out = run_mode(0)
        enc_samples.append(round(t_enc, 3))
        dec_samples.append(round(t_dec, 3))
        for _ in range(4):
            e2, d2, _ = run_mode(0)
            enc_samples.append(round(e2, 3))
            dec_samples.append(round(d2, 3))
            t_enc, t_dec = min(t_enc, e2), min(t_dec, d2)
        ours = {"rate": s_out.stats.rate,
                "distortion": s_out.stats.distortion}
        log(f"ours/sharded: encode {t_enc:.2f}s decode {t_dec:.2f}s "
            f"rate {ours['rate']:.4f} distortion {ours['distortion']:.4f}")
        if our_dec.stat().st_size != nbytes:
            log("FATAL: decoded size mismatch")
            sys.exit(1)

        # --- streaming encoder (bounded-memory production path) ----------
        from qvz_tpu.pipeline.streaming import encode_streaming
        st_q = tmp / "stream.q"
        t0 = time.perf_counter()
        st = encode_streaming(str(inp), str(st_q),
                              well_state=WellState.debug(), ratio=0.5)
        t_st = time.perf_counter() - t0
        same = st_q.read_bytes() == our_q.read_bytes()
        log(f"ours/streaming: encode {t_st:.2f}s rate {st['rate']:.4f} "
            f"({st['shards']} shards, container "
            f"{'byte-equal to in-memory' if same else 'DIFFERS'})")

        # --- device legs: forced device encode + device decode, each
        # byte-checked against the host engine at the same shard plan.
        data = load_quality_file(str(inp))
        device_kernels(data, telemetry)
        runs = []
        for _ in range(2):   # first run compiles; keep the faster
            t0 = time.perf_counter()
            dev = enc_mod.encode(data, dist, n_clusters=1, ratio=0.5,
                                 well_state=WellState.debug(), shards=0,
                                 use_jax=True, want_recon=False)
            runs.append((time.perf_counter() - t0, dev))
        te, dev = min(runs, key=lambda r: r[0])
        from qvz_tpu.format import container_v2
        from qvz_tpu.native import runtime as rt
        head = container_v2.parse(dev.compressed, blocks_len=None)
        tables = rt.tables_from_blocks(
            dev.compressed[container_v2.header_size():],
            head.cluster_count, head.columns)
        head = container_v2.parse(dev.compressed,
                                  blocks_len=tables.consumed)
        lanes = len(head.shards) - head.priming
        host = enc_mod.encode(data, dist, n_clusters=1, ratio=0.5,
                              well_state=WellState.debug(), shards=lanes,
                              use_jax=False, want_recon=False)
        if dev.compressed != host.compressed:
            log("FATAL: device container != host engine container")
            sys.exit(1)
        telemetry["device_encode_s"] = round(te, 3)
        telemetry["device_phases"] = {
            k: round(v, 3) for k, v in dev.stats.phase_seconds.items()}
        telemetry["coder_fallback_lanes"] = dev.stats.coder_fallback_lanes
        log(f"ours/device encode: {te:.2f}s ({lanes} lanes, container "
            f"byte-equal to the host engine) phases "
            f"{telemetry['device_phases']}")
        want = dec_mod.decode(dev.compressed)
        runs = []
        for _ in range(2):
            t0 = time.perf_counter()
            got = dec_mod.decode(dev.compressed, device=True)
            runs.append(time.perf_counter() - t0)
        if not (got == want).all():
            log("FATAL: device decode != host decode")
            sys.exit(1)
        telemetry["device_decode_s"] = round(min(runs), 3)
        log(f"ours/device decode: {min(runs):.2f}s (byte-equal to the "
            f"host decoder)")

        # --- byte-exact parity leg: a DEBUG reference build pins the
        # WELL seed (src/qv_stream.c:82), so the v1 container must match
        # OUR --debug-seed encode byte for byte on the bench corpus.
        if REFERENCE_SRC.is_dir():
            refdbg = tmp / "refdbg"
            shutil.copytree(REFERENCE_SRC, refdbg)
            r = subprocess.run(["make", "debug"], cwd=refdbg,
                               capture_output=True)
            dbg_bin = refdbg / "bin" / "qvz"
            if r.returncode == 0 and dbg_bin.exists():
                refq = tmp / "refdbg.q"
                subprocess.run([str(dbg_bin), "-f", "0.5", "-c", "1",
                                str(inp), str(refq)], check=True,
                               capture_output=True, timeout=3600)
                same = refq.read_bytes() == p_out.compressed
                log(f"parity/byte-exact vs debug reference on the "
                    f"bench corpus: {'OK' if same else 'MISMATCH'}")
                if not same:
                    sys.exit(1)

        # --- reference ---------------------------------------------------
        ref_bin = build_reference(tmp)
        if ref_bin is not None:
            ref_q, ref_dec = tmp / "ref.q", tmp / "ref.dec"
            rt_enc, rr = timed([str(ref_bin), "-f", "0.5", "-c", "1", "-s",
                                str(inp), str(ref_q)])
            refs = stats_line(rr.stdout)
            re2, _ = timed([str(ref_bin), "-f", "0.5", "-c", "1", "-s",
                            str(inp), str(ref_q)])
            rt_enc = min(rt_enc, re2)
            rt_dec, _ = timed([str(ref_bin), "-x", str(ref_q),
                               str(ref_dec)])
            rd2, _ = timed([str(ref_bin), "-x", str(ref_q), str(ref_dec)])
            rt_dec = min(rt_dec, rd2)

            # fixed-rate mode leg: the reference's quantizer design
            # explodes at high fixed rates; ours threads + dedups it
            from qvz_tpu.constants import MODE_FIXED
            t0 = time.perf_counter()
            enc_mod.encode(load_quality_file(str(inp)), dist,
                           n_clusters=1, mode=MODE_FIXED, ratio=2.0,
                           well_state=WellState.debug(), shards=0,
                           use_jax=False, want_recon=False)
            ours_r2 = time.perf_counter() - t0
            tr2, _ = timed([str(ref_bin), "-r", "2", "-c", "1", str(inp),
                            str(tmp / "ref_r2.q")])
            log(f"ours/fixed-rate -r 2: encode {ours_r2:.2f}s vs "
                f"reference {tr2:.2f}s ({tr2 / ours_r2:.1f}x; design "
                f"phase dominates the reference at high rates)")
            log(f"reference: encode {rt_enc:.2f}s decode {rt_dec:.2f}s "
                f"rate {refs.get('rate')} distortion "
                f"{refs.get('distortion')}")
            # parity of the operating point (seeds differ so bytes can't
            # be compared here; golden-config bit-parity lives in tests/)
            if refs and abs(refs["rate"] - ours["rate"]) > 0.01:
                log("FATAL: rate mismatch vs reference")
                sys.exit(1)
        else:
            rt_enc, rt_dec = FALLBACK_REF_ENCODE_S, FALLBACK_REF_DECODE_S
            log("reference not buildable; using embedded baseline times "
                f"encode {rt_enc:.2f}s decode {rt_dec:.2f}s")

        value = 2 * mb / (t_enc + t_dec)
        base = 2 * mb / (rt_enc + rt_dec)
        telemetry["sharded_enc_samples_s"] = enc_samples
        telemetry["sharded_dec_samples_s"] = dec_samples
        telemetry["loadavg"] = [round(x, 2) for x in os.getloadavg()]
        print(json.dumps({
            "metric": "e2e quality-score encode+decode throughput, "
                      "sharded production mode "
                      f"({N_LINES // 1000}k lines x {COLS} cols, -f 0.5, "
                      "identical reconstruction to reference mode)",
            "value": round(value, 3),
            "unit": "MB/s",
            "vs_baseline": round(value / base, 3),
            "telemetry": telemetry,
        }))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
