"""Command-line interface, flag-compatible with reference qvz.

Usage: python -m qvz_tpu (options) [input file] [output file]

Flags mirror src/main.c:166-184 (-q/-x/-f/-r/-d/-D/-c/-T/-u/-h/-s/-v)
plus framework extensions:
  --debug-seed     fixed WELL state (reference `make debug` behavior)
  --well-state F   load the 128-byte WELL state from a file
  --no-jax / --jax  force host-only / device pipeline (default: auto)

Documented divergence from the reference: when neither -f nor -r is
given, the mode defaults to MODE_RATIO with ratio 0.5 (the reference
leaves opts.mode uninitialized, src/main.c:198-204).
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

from qvz_tpu.constants import (
    DISTORTION_CUSTOM,
    DISTORTION_LORENTZ,
    DISTORTION_MANHATTAN,
    DISTORTION_MSE,
    MODE_FIXED,
    MODE_RATIO,
)
from qvz_tpu.ops.distortion import make_matrix
from qvz_tpu.ops.well import WellState


def usage(name: str) -> None:
    print(f"Usage: {name} (options) [input file] [output file]")
    print("Options are:")
    print("   -q           : Store quality values in compressed file (default)")
    print("   -x           : Extract quality values from compressed file")
    print("   -f [ratio]   : Compress using [ratio] bits per bit of input entropy per symbol")
    print("   -r [rate]    : Compress using fixed [rate] bits per symbol")
    print("   -d [M|L|A]   : Optimize for MSE, Log(1+L1), L1 distortions, respectively (default: MSE)")
    print("   -D [FILE]    : Optimize using the custom distortion matrix specified in FILE")
    print("   -c [#]       : Compress using [#] clusters (default: 1)")
    print("   -T [#]       : Use [#] as a threshold for cluster center movement (default: 4)")
    print("   -u [FILE]    : Write the uncompressed lossy values to FILE (default: off)")
    print("   -h           : Print this help")
    print("   -s           : Print summary stats")
    print("   -v           : Enable verbose output")
    print("   --debug-seed : Use the fixed WELL seed (reproducible bitstreams)")
    print("   --well-state F : Load a raw 128-byte WELL state from F")
    print("   --no-jax     : Force the host-only pipeline (no accelerator)")
    print("   --jax        : Force the device pipeline (default: auto by input size")
    print("                  on a GPU backend);")
    print("                  with -x, decode QVZ2 shards in device lanes")
    print("   --reuse-books F : Reuse the codebooks of a previous compressed file F")
    print("                  (skips the statistics + design phases)")
    print("   --profile D  : Write phase-timing JSON (and, with QVZ_TPU_JAX_TRACE=1,")
    print("                  a jax.profiler trace) to directory D")
    print("   --shards N   : Encode a sharded QVZ2 container with N parallel streams")
    print("                  (0 = one per CPU; default 1 = reference-compatible v1)")
    print("   --hosts N    : Encode (or decode a QVZ2 container) across N worker")
    print("                  processes; output byte-identical to --hosts 1")
    print("   --no-prime   : Disable QVZ2 shard priming (priming: shards start")
    print("                  from the warmup shard's model state; ~0.06% rate")
    print("                  overhead vs v1 instead of ~0.7%)")
    print("   --streaming  : Bounded-memory encode (chunked stats, shard-wave")
    print("                  coding, streamed container writes; auto above")
    print("                  QVZ_TPU_STREAM_MIN_BYTES, default 1 GiB;")
    print("                  composes with --hosts N: workers stream their")
    print("                  row ranges, container assembles straight to disk)")
    print(" Env knobs: QVZ_TPU_DEVICE_MIN_BYTES (auto device dispatch size,")
    print("   GPU backends only), QVZ_TPU_DEVICE_CODER (device entropy")
    print("   encoder), QVZ_TPU_DEVICE_DECODE / QVZ_TPU_DEC_WAVE (device")
    print("   entropy decoder), QVZ_TPU_DEVICE_LANES (device shard plan),")
    print("   JAX_COMPILATION_CACHE_DIR (default: build/jax_cache)")


def _make_well(opts) -> WellState:
    if opts.get("well_state_file"):
        return WellState.from_bytes(
            open(opts["well_state_file"], "rb").read(128))
    if opts.get("debug_seed"):
        return WellState.debug()
    # Reference behavior: srand(time(0)) then 32 rand() draws
    # (qv_stream.c:76-84); we use os.urandom for better seeding.
    words = np.frombuffer(os.urandom(128), dtype="<u4")
    return WellState(words.tolist())


def main(argv=None) -> int:
    argv = list(sys.argv if argv is None else argv)
    name = argv[0] if argv else "qvz_tpu"
    opts = {
        "verbose": False, "stats": False, "ratio": 0.5, "clusters": 1,
        "uncompressed": None, "distortion": DISTORTION_MSE,
        "mode": MODE_RATIO, "cluster_threshold": 4.0, "dist_file": None,
        "debug_seed": False, "well_state_file": None, "use_jax": "auto",
        "shards": 1, "profile_dir": None, "reuse_books": None,
        "hosts": 1, "prime": True, "streaming": False,
    }
    i = 1
    try:
        return _parse_and_dispatch(argv, name, opts, i)
    except (ValueError, IndexError) as e:
        if isinstance(e, IndexError):
            print("Missing value for option.")
        else:
            print(f"Bad option value: {e}")
        usage(name)
        return 1


def _parse_and_dispatch(argv, name, opts, i) -> int:
    extract = False
    files = []
    while i < len(argv):
        a = argv[i]
        if not a.startswith("-"):
            files.append(a)
            i += 1
            continue
        if a == "-x":
            extract = True
            i += 1
        elif a == "-q":
            extract = False
            i += 1
        elif a == "-f":
            opts["ratio"] = float(argv[i + 1])
            opts["mode"] = MODE_RATIO
            i += 2
        elif a == "-r":
            opts["ratio"] = float(argv[i + 1])
            opts["mode"] = MODE_FIXED
            i += 2
        elif a == "-c":
            opts["clusters"] = int(argv[i + 1])
            i += 2
        elif a == "-T":
            opts["cluster_threshold"] = float(int(argv[i + 1]))
            i += 2
        elif a == "-v":
            opts["verbose"] = True
            i += 1
        elif a == "-s":
            opts["stats"] = True
            i += 1
        elif a == "-u":
            opts["uncompressed"] = argv[i + 1]
            i += 2
        elif a == "-d":
            sel = argv[i + 1][0]
            if sel == "M":
                opts["distortion"] = DISTORTION_MSE
            elif sel == "L":
                opts["distortion"] = DISTORTION_LORENTZ
            elif sel == "A":
                opts["distortion"] = DISTORTION_MANHATTAN
            else:
                print("Distortion measure not supported, using MSE.")
            i += 2
        elif a == "-D":
            opts["distortion"] = DISTORTION_CUSTOM
            opts["dist_file"] = argv[i + 1]
            i += 2
        elif a == "--debug-seed":
            opts["debug_seed"] = True
            i += 1
        elif a == "--well-state":
            opts["well_state_file"] = argv[i + 1]
            i += 2
        elif a == "--reuse-books":
            opts["reuse_books"] = argv[i + 1]
            i += 2
        elif a == "--profile":
            opts["profile_dir"] = argv[i + 1]
            i += 2
        elif a == "--no-jax":
            opts["use_jax"] = False
            i += 1
        elif a == "--jax":
            opts["use_jax"] = True
            i += 1
        elif a == "--shards":
            opts["shards"] = int(argv[i + 1])
            i += 2
        elif a == "--hosts":
            opts["hosts"] = int(argv[i + 1])
            i += 2
        elif a == "--no-prime":
            opts["prime"] = False
            i += 1
        elif a == "--streaming":
            opts["streaming"] = True
            i += 1
        elif a == "-h":
            usage(name)
            return 0
        else:
            print(f"Unrecognized option {a}.")
            usage(name)
            return 1

    if len(files) != 2:
        print("Missing required filenames.")
        usage(name)
        return 1
    input_name, output_name = files

    if opts["verbose"]:
        # reference preamble, main.c:311-340 (same wording/format)
        if extract:
            print(f"{input_name} will be decoded to {output_name}.")
        else:
            print(f"{input_name} will be encoded as {output_name}.")
            if opts["mode"] == MODE_RATIO:
                print(f"Ratio mode selected, targeting "
                      f"{opts['ratio']:f} compression ratio.")
            else:
                print(f"Fixed-rate mode selected, targeting "
                      f"{opts['ratio']:f} bits per symbol.")
            if opts["distortion"] == DISTORTION_MSE:
                print("MSE will be used as a distortion metric.")
            elif opts["distortion"] == DISTORTION_LORENTZ:
                print("log(1+L1) will be used as a distortion metric.")
            elif opts["distortion"] == DISTORTION_MANHATTAN:
                print("L1 will be used as a distortion metric.")
            elif opts["distortion"] == DISTORTION_CUSTOM:
                print(f"A custom distortion metric stored in "
                      f"{opts['dist_file']} will be used.")
            print(f"Compression will use {opts['clusters']} clusters, "
                  f"with a movement threshold of "
                  f"{opts['cluster_threshold']:.0f}.")

    import contextlib

    from qvz_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    profiled = contextlib.nullcontext()
    if opts.get("profile_dir") and os.environ.get("QVZ_TPU_JAX_TRACE"):
        # The full jax.profiler trace is opt-in (it is large and slows
        # the host); the default --profile output is the phase-level
        # timing JSON written by _run.
        import jax
        profiled = jax.profiler.trace(opts["profile_dir"])

    try:
        with profiled:
            return _run(opts, extract, input_name, output_name)
    except FileNotFoundError as e:
        print(f"Cannot open file: {e.filename}")
        return 1
    except ValueError as e:
        print(f"Error: {e}")
        return 1


def _run(opts, extract, input_name, output_name) -> int:
    if extract:
        t0 = time.perf_counter()
        if opts.get("hosts", 1) > 1:
            from qvz_tpu.format import container_v2
            with open(input_name, "rb") as f:
                magic = f.read(4)
            if container_v2.is_v2(magic):
                from qvz_tpu.parallel.multihost import decode_multihost
                n = decode_multihost(input_name, output_name,
                                     n_hosts=opts["hosts"])
                if opts["verbose"]:
                    print(f"Decoded {n} lines on {opts['hosts']} hosts "
                          f"in {time.perf_counter() - t0:.4f} seconds.")
                return 0
            # v1 containers are a single sequential stream: fall through
        from qvz_tpu.pipeline import decode as dec_mod
        # --jax routes column-major QVZ2 shards through the lane-
        # parallel device decoder (ops/decoder_device.py); --no-jax
        # forces host threads; default defers to QVZ_TPU_DEVICE_DECODE
        dev = (True if opts["use_jax"] is True
               else False if opts["use_jax"] is False else None)
        n = dec_mod.decode_file_to_file(input_name, output_name,
                                        verbose=opts["verbose"],
                                        device=dev)
        if opts["verbose"]:
            # reference format main.c:98 uses %f, not %.4f
            print(f"Decoded {n} lines in "
                  f"{time.perf_counter() - t0:f} seconds.")
        return 0

    from qvz_tpu.pipeline import encode as enc_mod
    from qvz_tpu.spec.pipeline import load_quality_file, lines_to_bytes

    t0 = time.perf_counter()
    dist = make_matrix(opts["distortion"], path=opts["dist_file"])

    stream_min = int(os.environ.get("QVZ_TPU_STREAM_MIN_BYTES",
                                    1 * 2**30))
    # Auto-streaming engages above the size threshold only when the
    # option set is compatible: never with --reuse-books / -u (those
    # fall back to the in-memory path instead of erroring), and never
    # when the user kept the default --shards 1 (that promises a
    # reference-compatible v1 container, which streaming — a QVZ2-only
    # mode — would silently break). Explicit --streaming still errors
    # on a genuinely unsupported combination.
    auto_stream = (not opts.get("streaming")
                   and os.path.getsize(input_name) >= stream_min
                   and opts["shards"] != 1
                   and not opts.get("reuse_books")
                   and not opts.get("uncompressed"))
    if (opts.get("streaming") or auto_stream) \
            and opts.get("hosts", 1) == 1:
        # Bounded-memory streaming encode (QVZ2 only).
        if opts.get("reuse_books"):
            raise ValueError(
                "--streaming does not support --reuse-books")
        from qvz_tpu.pipeline.streaming import encode_streaming
        st = encode_streaming(
            input_name, output_name, n_clusters=opts["clusters"],
            mode=opts["mode"], ratio=opts["ratio"],
            cluster_threshold=opts["cluster_threshold"],
            well_state=_make_well(opts), dist_matrix=dist,
            shards=opts["shards"] if opts["shards"] != 1 else 0,
            prime=opts["prime"],
            recon_path=opts.get("uncompressed"),
            use_jax=opts["use_jax"] is True,
            verbose=opts["verbose"])
        elapsed = time.perf_counter() - t0
        if opts["verbose"]:
            print(f"Streaming encode: {st['shards']} shards, "
                  f"{st['lines']} lines.")
            for k in ("cluster_s", "stats_s", "design_s", "code_s"):
                print(f"  {k[:-2]}: {st[k]:.4f}s")
        if opts["stats"]:
            print(f"rate, {st['rate']:.4f}, distortion, "
                  f"{st['distortion']:.4f}, time, {elapsed:.4f}, size, "
                  f"{st['payload_bytes']} ")
        return 0

    if opts.get("hosts", 1) > 1:
        # Multi-host driver: N worker processes over contiguous read
        # ranges, container byte-identical to the 1-process encode.
        # --streaming (or auto-streaming above the size threshold)
        # composes: workers stream their row ranges and the container
        # assembles straight to disk (bounded RSS at any corpus size).
        if opts.get("reuse_books"):
            raise ValueError("--hosts does not support --reuse-books")
        from qvz_tpu.parallel.multihost import encode_multihost
        mh_streaming = bool(opts.get("streaming") or auto_stream)
        compressed, mh = encode_multihost(
            input_name, n_hosts=opts["hosts"],
            shards=opts["shards"] if opts["shards"] != 1 else 0,
            n_clusters=opts["clusters"], mode=opts["mode"],
            ratio=opts["ratio"],
            cluster_threshold=opts["cluster_threshold"],
            well_state=_make_well(opts), dist_matrix=dist,
            prime=opts["prime"],
            recon_path=opts.get("uncompressed"),
            verbose=opts["verbose"],
            streaming=mh_streaming,
            output_path=output_name if mh_streaming else None)
        if compressed is not None:
            with open(output_name, "wb") as f:
                f.write(compressed)
        elapsed = time.perf_counter() - t0
        if opts["verbose"]:
            print(f"Multi-host encode: {mh['hosts']} hosts, "
                  f"{mh['shards']} shards, {mh['lines']} lines.")
        if opts["stats"]:
            print(f"rate, {mh['rate']:.4f}, distortion, "
                  f"{mh['distortion']:.4f}, time, {elapsed:.4f}, size, "
                  f"{mh['payload_bytes']} ")
        return 0

    data = load_quality_file(input_name)
    reuse_blocks = None
    if opts.get("reuse_books"):
        from qvz_tpu.format import container_v2
        prev = open(opts["reuse_books"], "rb").read()
        if container_v2.is_v2(prev):
            head = container_v2.parse(prev, blocks_len=None)
            if head.cluster_count != opts["clusters"]:
                raise ValueError("--reuse-books cluster count mismatch")
            reuse_blocks = prev[container_v2.header_size():]
        else:
            cc, _, _ = __import__("qvz_tpu.format.container",
                                  fromlist=["read_header"]
                                  ).read_header(prev[:9])
            if cc != opts["clusters"]:
                raise ValueError("--reuse-books cluster count mismatch")
            reuse_blocks = prev[9:]
    out = enc_mod.encode(
        data, dist, n_clusters=opts["clusters"], mode=opts["mode"],
        ratio=opts["ratio"], cluster_threshold=opts["cluster_threshold"],
        well_state=_make_well(opts), use_jax=opts["use_jax"],
        shards=opts["shards"], reuse_blocks=reuse_blocks,
        want_recon=bool(opts["uncompressed"]), prime=opts["prime"],
        verbose=opts["verbose"])
    with open(output_name, "wb") as f:
        f.write(out.compressed)
    if opts["uncompressed"]:
        with open(opts["uncompressed"], "wb") as f:
            f.write(lines_to_bytes(out.reconstructed))
    elapsed = time.perf_counter() - t0

    if opts.get("profile_dir"):
        import json
        import pathlib
        pdir = pathlib.Path(opts["profile_dir"])
        pdir.mkdir(parents=True, exist_ok=True)
        (pdir / "phases.json").write_text(json.dumps({
            "lines": out.stats.lines, "columns": out.stats.columns,
            "rate": out.stats.rate, "distortion": out.stats.distortion,
            "payload_bytes": out.stats.payload_bytes,
            "total_seconds": elapsed,
            "phase_seconds": out.stats.phase_seconds,
            "device_seconds": out.stats.device_seconds,
            "coder_fallback_lanes": out.stats.coder_fallback_lanes,
            "throughput_MBps": out.stats.lines
            * (out.stats.columns + 1) / max(elapsed, 1e-9) / 1e6,
        }, indent=2))

    if opts["verbose"]:
        labels = {DISTORTION_MSE: "MSE", DISTORTION_LORENTZ: "log(1+L1)",
                  DISTORTION_MANHATTAN: "L1", DISTORTION_CUSTOM: "Custom"}
        print(f"{labels[opts['distortion']]} distortion: "
              f"{out.stats.distortion:f}")
        print(f"Lines: {out.stats.lines}")
        print(f"Columns: {out.stats.columns}")
        print(f"Total bytes used: {out.stats.payload_bytes}")
        print(f"Encoding took {elapsed:.4f} seconds.")
        print(f"Total time elapsed: {elapsed:.4f} seconds.")
        # finer-grained phase split: ours only (documented stdout
        # addition, DESIGN.md divergence table)
        for phase, sec in out.stats.phase_seconds.items():
            print(f"  {phase}: {sec:.4f}s")
    if opts["stats"]:
        # Machine-parseable line, format-compatible with main.c:125.
        print(f"rate, {out.stats.rate:.4f}, distortion, "
              f"{out.stats.distortion:.4f}, time, {elapsed:.4f}, size, "
              f"{out.stats.payload_bytes} ")
    return 0


if __name__ == "__main__":
    sys.exit(main())
