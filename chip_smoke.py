#!/usr/bin/env python
"""Drive the encode/decode device path once on a GPU and check it.

    python chip_smoke.py [--seed N] [--four-cards]

Runs the CLI's main function in-process (one process holds the card),
with the C++ host engine (`--no-jax`) as the reference in the same
process. Inputs are Illumina-like quality walks generated from --seed:
151 columns (2x150 runs) at 2,000,000 reads, above the 256 MiB auto
device threshold. Every device phase is exact integer arithmetic, so
every comparison is byte equality:

  1. device check: JAX's backend is a GPU; card name and power limit
  2. QVZ2 device encode (`-f 0.5 -c 1 --shards 0 -s -u`, auto dispatch):
     stats, quantize and the lane coder on the device, no fallback
     lanes, container == host engine's at the same shard count,
     `-x` decode == `-u` reconstruction
  3. device decode of that container == host decode
  4. v1 default mode (`-f 0.5 -c 1`): device stats + host coder,
     container == `--no-jax`
  5. multi-cluster (`-c 3 -T 4 --jax --shards 0`) at 500,000 reads on
     tie-heavy data: device k-means (first-minimum ties) and cluster
     triples in the lane coder
  6. envelope edge: 1022 columns x 16,384 reads, `--jax --shards 32`

--four-cards runs only phase 2's encode at 8,000,000 reads over a
4-GPU mesh (`encode(mesh=...)`) against the host engine, and
`__graft_entry__.dryrun_multichip(4)`.

Any failure raises (exit code != 0). The last stdout line is one JSON
object: {"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

from qvz_tpu import cli  # noqa: E402
from qvz_tpu.format import container_v2  # noqa: E402
from qvz_tpu.native import runtime as rt  # noqa: E402
from qvz_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

COLS = 151
READS = 2_000_000
CLUSTER_READS = 500_000
EDGE_COLS, EDGE_READS = 1022, 16_384
MESH_READS = 8_000_000


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def illumina(n: int, cols: int, seed: int, step: int = 2) -> np.ndarray:
    """(n, cols) Phred symbols: a per-read random walk starting at Q28-39
    and drifting down along the read, clipped to Q2-41."""
    rng = np.random.default_rng(seed)
    out = np.empty((n, cols), dtype=np.uint8)
    drift = np.arange(cols - 1) // 40
    for lo in range(0, n, 250_000):
        hi = min(n, lo + 250_000)
        start = rng.integers(28, 40, size=(hi - lo, 1), dtype=np.int16)
        steps = rng.integers(-step, step + 1, size=(hi - lo, cols - 1),
                             dtype=np.int16) - drift.astype(np.int16)
        out[lo:hi] = np.clip(np.concatenate([start, steps], 1).cumsum(
            1, dtype=np.int16), 2, 41)
    return out


def tie_heavy(n: int, cols: int, seed: int, k: int) -> np.ndarray:
    """Illumina-like reads on which k-means' first iteration ties every
    read between centroids 0 and 1: the two seed rows the reference
    draws (glibc rand() seed 1, cluster.c:192-206) differ only in one
    column, by -2 and +2 around a value every other read holds there.
    The reference needs the lowest index on ties."""
    from qvz_tpu.utils.glibc_rand import GlibcRand

    q = illumina(n, cols, seed)
    rand = GlibcRand(1)
    idx = []
    for _ in range(k):
        rand.rand()                  # block id (one block below 1M reads)
        idx.append(rand.rand() % n)
    check(len(set(idx)) == k, f"seed rows collide: {idx}")
    j = cols // 2
    q[:, j] = 30
    q[idx[1]] = q[idx[0]]
    q[idx[0], j] = 28
    q[idx[1], j] = 32
    return q


def kmeans_step_vs_spec(q: np.ndarray) -> None:
    """One device Lloyd step against the numpy spec's first-minimum
    assignment, at several read counts: a matmul-based form of this
    step was wrong on the card at some counts and right at others."""
    import jax.numpy as jnp

    from qvz_tpu.ops.kmeans import _kmeans_step
    from qvz_tpu.spec.kmeans import kmeans_assign

    means = q[[5, 77, 901]].astype(np.int32)
    for n in (2001, 3703, 3707, 3708, 100_000):
        a, _, _ = _kmeans_step(jnp.asarray(q[:n]), jnp.asarray(means), 3)
        check(np.array_equal(np.asarray(a),
                             kmeans_assign(q[:n].astype(np.int32), means)),
              f"phase 5: device k-means step != spec at {n} reads")
    print("phase 5: device k-means step == spec at 2001, 3703, 3707, "
          "3708 and 100000 reads", flush=True)


def write_quality(path: pathlib.Path, q: np.ndarray) -> None:
    with open(path, "wb") as f:
        for lo in range(0, len(q), 250_000):
            blk = q[lo:lo + 250_000]
            out = np.empty((len(blk), q.shape[1] + 1), dtype=np.uint8)
            out[:, :-1] = blk + 33
            out[:, -1] = 10
            f.write(out.tobytes())


def run_cli(*argv: str) -> float:
    t0 = time.perf_counter()
    rc = cli.main(["qvz", *argv])
    check(rc == 0, f"qvz {' '.join(argv)} exited {rc}")
    return time.perf_counter() - t0


def shard_lanes(comp: bytes) -> int:
    """The device's lane count: the container's shards minus the
    priming warmup shard — the explicit --shards value that makes the
    host engine plan the same layout."""
    head = container_v2.parse(comp, blocks_len=None)
    tables = rt.tables_from_blocks(comp[container_v2.header_size():],
                                   head.cluster_count, head.columns)
    head = container_v2.parse(comp, blocks_len=tables.consumed)
    return len(head.shards) - head.priming


def report(name: str, wall: float, name_card: str,
           prof: pathlib.Path | None = None) -> dict:
    """Print one phase's wall time beside the card, with the CLI's
    --profile phase split when there is one."""
    line = f"{name}: wall {wall:.3f} s | {name_card}"
    ph = {}
    if prof is not None:
        ph = json.loads((prof / "phases.json").read_text())
        line += (f" | phase_seconds {json.dumps(ph['phase_seconds'])}"
                 f" | device_seconds {json.dumps(ph['device_seconds'])}")
    print(line, flush=True)
    return ph


def device_encode_vs_host(stem: pathlib.Path, tag: str, q: np.ndarray,
                          flags: list[str], device_phases: set[str],
                          name_card: str, shards: str = "0") -> bytes:
    """Encode `q` on the device through the CLI, then with the host
    engine at the same explicit shard count; containers must be equal
    and the `-x` decode must equal the `-u` reconstruction. Files are
    stem.in, stem.dev.q, stem.dec, ..."""
    inp, prof = stem.with_suffix(".in"), stem.with_suffix(".prof")
    dev_q, host_q = stem.with_suffix(".dev.q"), stem.with_suffix(".host.q")
    recon, dec = stem.with_suffix(".u"), stem.with_suffix(".dec")
    write_quality(inp, q)
    wall = run_cli(*flags, "--shards", shards, "-s", "-u", str(recon),
                   "--debug-seed", "--profile", str(prof), str(inp),
                   str(dev_q))
    ph = report(f"{tag} device encode", wall, name_card, prof)
    missing = device_phases - set(ph["device_seconds"])
    check(not missing, f"{tag}: phases {missing} did not run on the "
          f"device: {ph['device_seconds']}")
    check(ph["coder_fallback_lanes"] == 0,
          f"{tag}: {ph['coder_fallback_lanes']} coder fallback lanes")
    comp = dev_q.read_bytes()
    lanes = shard_lanes(comp)
    host_flags = [f for f in flags if f != "--jax"]
    wall = run_cli(*host_flags, "--no-jax", "--shards", str(lanes),
                   "--debug-seed", str(inp), str(host_q))
    report(f"{tag} host engine encode ({lanes} shards)", wall, name_card)
    check(comp == host_q.read_bytes(),
          f"{tag}: device container != host engine container")
    wall = run_cli("-x", str(dev_q), str(dec))
    report(f"{tag} host decode", wall, name_card)
    check(dec.read_bytes() == recon.read_bytes(),
          f"{tag}: decoded output != -u reconstruction")
    print(f"{tag}: container byte-equal to the host engine "
          f"({len(comp)} bytes, {lanes} lanes), decode == -u", flush=True)
    return comp


def single_card(seed: int) -> None:
    from qvz_tpu.pipeline import decode as dec_mod

    name_card = card()
    with tempfile.TemporaryDirectory(prefix="qvz_smoke_") as td:
        tmp = pathlib.Path(td)

        # 2. QVZ2 device encode, auto dispatch
        q = illumina(READS, COLS, seed)
        comp = device_encode_vs_host(
            tmp / "p2", "phase 2 QVZ2", q, ["-f", "0.5", "-c", "1"],
            {"stats", "quantize", "device_code"}, name_card)

        # 3. device decode of phase 2's container
        t0 = time.perf_counter()
        out = dec_mod.decode(comp, device=True)
        wall = time.perf_counter() - t0
        report("phase 3 device decode", wall, name_card)
        check(out.tobytes() == (tmp / "p2.dec").read_bytes(),
              "phase 3: device decode != host decode")
        print("phase 3: device decode byte-equal to the host decode",
              flush=True)
        del out

        # 4. v1 default mode: device stats, host coder
        inp, prof = tmp / "p2.in", tmp / "v1.prof"
        wall = run_cli("-f", "0.5", "-c", "1", "--debug-seed", "--profile",
                       str(prof), str(inp), str(tmp / "v1.dev.q"))
        ph = report("phase 4 v1 auto encode", wall, name_card, prof)
        check("stats" in ph["device_seconds"],
              f"phase 4: stats did not run on the device: "
              f"{ph['device_seconds']}")
        wall = run_cli("-f", "0.5", "-c", "1", "--debug-seed", "--no-jax",
                       str(inp), str(tmp / "v1.host.q"))
        report("phase 4 v1 host engine encode", wall, name_card)
        check((tmp / "v1.dev.q").read_bytes()
              == (tmp / "v1.host.q").read_bytes(),
              "phase 4: v1 container != --no-jax container")
        print("phase 4: v1 container byte-equal to --no-jax", flush=True)
        del q

        # 5. multi-cluster on tie-heavy data
        q = tie_heavy(CLUSTER_READS, COLS, seed + 1, 3)
        kmeans_step_vs_spec(q)
        device_encode_vs_host(
            tmp / "p5", "phase 5 clusters", q,
            ["-f", "0.5", "-c", "3", "-T", "4", "--jax"],
            {"cluster", "stats", "quantize", "device_code"}, name_card)

        # 6. envelope edge: 1022 columns
        device_encode_vs_host(
            tmp / "p6", "phase 6 1022 cols", illumina(EDGE_READS, EDGE_COLS,
                                               seed + 2, step=1),
            ["-f", "0.5", "-c", "1", "--jax"],
            {"stats", "quantize", "device_code"}, name_card, shards="32")


def four_cards(seed: int) -> None:
    import jax

    from qvz_tpu.constants import DISTORTION_MSE
    from qvz_tpu.ops.distortion import make_matrix
    from qvz_tpu.ops.well import WellState
    from qvz_tpu.parallel.mesh import make_mesh
    from qvz_tpu.pipeline import encode as enc_mod

    check(len(jax.devices()) >= 4, f"need 4 GPUs: {jax.devices()}")
    name_card = card()
    q = illumina(MESH_READS, COLS, seed)
    dist = make_matrix(DISTORTION_MSE)
    kw = dict(well_state=WellState.debug(), want_recon=False)
    t0 = time.perf_counter()
    dev = enc_mod.encode(q, dist, mesh=make_mesh(4), use_jax=True,
                         shards=0, **kw)
    print(f"four-card mesh encode: wall {time.perf_counter() - t0:.3f} s"
          f" | {name_card} | phase_seconds "
          f"{json.dumps(dev.stats.phase_seconds)} | device_seconds "
          f"{json.dumps(dev.stats.device_seconds)}", flush=True)
    check(dev.stats.coder_fallback_lanes == 0, "mesh: fallback lanes")
    check({"stats", "quantize", "device_code"}
          <= set(dev.stats.device_seconds), "mesh: phases off device")
    lanes = shard_lanes(dev.compressed)
    t0 = time.perf_counter()
    host = enc_mod.encode(q, dist, use_jax=False, shards=lanes, **kw)
    print(f"four-card host engine encode ({lanes} shards): wall "
          f"{time.perf_counter() - t0:.3f} s | {name_card}", flush=True)
    check(dev.compressed == host.compressed,
          "mesh container != host engine container")
    print(f"four-card mesh encode: container byte-equal to the host "
          f"engine ({len(dev.compressed)} bytes, {lanes} lanes)",
          flush=True)
    del q, dev, host

    import __graft_entry__

    t0 = time.perf_counter()
    __graft_entry__.dryrun_multichip(4)
    print(f"dryrun_multichip(4): ok, wall {time.perf_counter() - t0:.3f} s"
          f" | {name_card}", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four-cards", action="store_true",
                    help="only the 4-GPU mesh encode and the multichip "
                         "dry run")
    args = ap.parse_args()

    import jax

    t0 = time.perf_counter()
    cache = enable_compile_cache()
    check(jax.default_backend() == "gpu",
          f"no GPU: JAX's default backend is {jax.default_backend()}")
    dev0 = jax.devices()[0]
    check(dev0.platform == "gpu", f"device 0 is {dev0.platform}")
    name_card = card()
    print(f"phase 1 device: {dev0.device_kind} x{len(jax.devices())} | "
          f"{name_card} | jax {jax.__version__} | compile cache {cache}",
          flush=True)

    if args.four_cards:
        four_cards(args.seed)
    else:
        single_card(args.seed)
    print(f"total wall {time.perf_counter() - t0:.3f} s", flush=True)
    print(name_card)
    print(json.dumps({"ok": True, "device": {
        "platform": dev0.platform, "kind": dev0.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
