"""Live parity vs the reference binary built from /root/reference.

Stronger than the checked-in goldens: randomized inputs and CLI configs,
encode and decode compared byte-for-byte against a fresh `make debug`
build (fixed WELL seed, src/qv_stream.c:82). Skipped when the reference
tree isn't mounted.
"""

import pathlib
import shutil
import subprocess

import numpy as np
import pytest

REF_SRC = pathlib.Path("/root/reference")

pytestmark = pytest.mark.skipif(not REF_SRC.is_dir(),
                                reason="reference tree not available")


@pytest.fixture(scope="session")
def ref_bin(tmp_path_factory):
    build = tmp_path_factory.mktemp("refbuild")
    shutil.copytree(REF_SRC, build, dirs_exist_ok=True)
    r = subprocess.run(["make", "debug"], cwd=build, capture_output=True)
    binary = build / "bin" / "qvz"
    if r.returncode != 0 or not binary.exists():
        pytest.skip("reference build failed")
    return binary


def synth_file(path, n, cols, seed):
    rng = np.random.default_rng(seed)
    start = rng.integers(15, 50, size=(n, 1))
    steps = rng.integers(-4, 5, size=(n, cols - 1))
    q = np.clip(np.concatenate([start, steps], 1).cumsum(1), 0, 71)
    out = np.empty((n, cols + 1), dtype=np.uint8)
    out[:, :cols] = q.astype(np.uint8) + 33
    out[:, cols] = 10
    path.write_bytes(out.tobytes())


CONFIGS = [
    (["-f", "0.37", "-c", "1", "-d", "M"], 1500, 63, 101),
    (["-r", "1.3", "-c", "2", "-d", "L"], 900, 41, 202),
    (["-f", "0.8", "-c", "4", "-d", "A", "-T", "2"], 1200, 30, 303),
    # round-2 additions: more mode/space coverage
    (["-r", "0.15", "-c", "1", "-d", "A"], 2000, 24, 404),   # very low fixed rate
    (["-r", "3.7", "-c", "2", "-d", "M", "-T", "1"], 700, 33, 505),  # high fixed rate
    (["-f", "0.05", "-c", "3", "-d", "L"], 1100, 47, 606),   # near-zero ratio
    (["-f", "0.95", "-c", "1", "-d", "M"], 800, 52, 707),    # near-max ratio
    (["-f", "0.6", "-c", "5", "-d", "A", "-T", "8"], 1500, 28, 808),  # max rec. clusters, loose T
]


def test_custom_distortion_bit_parity(ref_bin, tmp_path):
    """-D custom-matrix mode (distortion.c:100-145), not covered by the
    checked-in goldens."""
    from qvz_tpu import cli

    # a well-behaved metric (zero diagonal, monotone in |x-y|): the
    # reference's design code crashes on arbitrary noisy matrices
    mat = np.round(np.abs(np.subtract.outer(np.arange(72.0),
                                            np.arange(72.0))) ** 1.5, 2)
    dfile = tmp_path / "dist.txt"
    lines = ["# custom matrix"]
    lines += [",".join(f"{v:g}" for v in row) for row in mat]
    dfile.write_text("\n".join(lines) + "\n")

    inp = tmp_path / "in.qual"
    synth_file(inp, 800, 25, 404)

    ref_q, our_q = tmp_path / "ref.q", tmp_path / "our.q"
    r = subprocess.run([str(ref_bin), "-f", "0.6", "-D", str(dfile),
                        "-s", str(inp), str(ref_q)], capture_output=True)
    assert r.returncode == 0, r.stderr
    assert cli.main(["qvz", "-f", "0.6", "-D", str(dfile), "--debug-seed",
                     "--no-jax", str(inp), str(our_q)]) == 0
    assert our_q.read_bytes() == ref_q.read_bytes()


@pytest.mark.parametrize("flags,n,cols,seed", CONFIGS)
def test_random_config_bit_parity(ref_bin, tmp_path, flags, n, cols, seed):
    from qvz_tpu import cli

    inp = tmp_path / "in.qual"
    synth_file(inp, n, cols, seed)

    ref_q = tmp_path / "ref.q"
    ref_u = tmp_path / "ref.u"
    ref_dec = tmp_path / "ref.dec"
    r = subprocess.run([str(ref_bin), *flags, "-u", str(ref_u), "-s",
                        str(inp), str(ref_q)], capture_output=True)
    assert r.returncode == 0, r.stderr
    assert subprocess.run([str(ref_bin), "-x", str(ref_q),
                           str(ref_dec)]).returncode == 0

    our_q = tmp_path / "our.q"
    our_u = tmp_path / "our.u"
    our_dec = tmp_path / "our.dec"
    assert cli.main(["qvz", *flags, "-u", str(our_u), "--debug-seed",
                     "--no-jax", str(inp), str(our_q)]) == 0
    assert cli.main(["qvz", "-x", str(our_q), str(our_dec)]) == 0

    assert our_q.read_bytes() == ref_q.read_bytes()
    assert our_u.read_bytes() == ref_u.read_bytes()
    assert our_dec.read_bytes() == ref_dec.read_bytes()

    # cross-decode: the reference binary must decode OUR container too
    cross = tmp_path / "cross.dec"
    assert subprocess.run([str(ref_bin), "-x", str(our_q),
                           str(cross)]).returncode == 0
    assert cross.read_bytes() == ref_dec.read_bytes()


def synth_skewed(path, n, cols, seed, kind):
    """Pathological data shapes the Illumina-like generator misses."""
    rng = np.random.default_rng(seed)
    if kind == "constant":
        q = np.full((n, cols), 38, dtype=np.uint8)
        q[n // 3] = 2  # one outlier line
    elif kind == "bimodal":
        lo = rng.integers(0, 6, size=(n, cols))
        hi = rng.integers(60, 72, size=(n, cols))
        pick = rng.random((n, 1)) < 0.5
        q = np.where(pick, lo, hi).astype(np.uint8)
    elif kind == "saturated":
        q = np.clip(rng.integers(66, 80, size=(n, cols)), 0,
                    71).astype(np.uint8)
    else:  # full-alphabet uniform noise
        q = rng.integers(0, 72, size=(n, cols)).astype(np.uint8)
    out = np.empty((n, cols + 1), dtype=np.uint8)
    out[:, :cols] = q + 33
    out[:, cols] = 10
    path.write_bytes(out.tobytes())


@pytest.mark.parametrize("kind", ["constant", "bimodal", "saturated",
                                  "uniform"])
def test_pathological_data_bit_parity(ref_bin, tmp_path, kind):
    """Degenerate statistics (constant columns, bimodal mixtures,
    saturated alphabet edges, full-entropy noise) stress the design
    phase's tie-breaks; containers must stay byte-equal."""
    from qvz_tpu import cli

    inp = tmp_path / "in.qual"
    synth_skewed(inp, 900, 35, 99, kind)
    ref_q, our_q = tmp_path / "ref.q", tmp_path / "our.q"
    r = subprocess.run([str(ref_bin), "-f", "0.5", "-c", "2", "-s",
                        str(inp), str(ref_q)], capture_output=True)
    if r.returncode != 0:
        # Documented reference crash class (DESIGN.md): k-means on
        # near-constant data empties a cluster and the reference
        # divides by zero (SIGFPE, cluster.c:113). OUR encoder must
        # handle the same input gracefully with a valid round-trip.
        assert kind == "constant" and r.returncode == -8, (kind, r)
        our_u = tmp_path / "our.u"
        assert cli.main(["qvz", "-f", "0.5", "-c", "2", "--debug-seed",
                         "--no-jax", "-u", str(our_u), str(inp),
                         str(our_q)]) == 0
        our_dec = tmp_path / "our.dec"
        assert cli.main(["qvz", "-x", str(our_q), str(our_dec)]) == 0
        assert our_dec.read_bytes() == our_u.read_bytes()
        return
    assert cli.main(["qvz", "-f", "0.5", "-c", "2", "--debug-seed",
                     "--no-jax", str(inp), str(our_q)]) == 0
    assert our_q.read_bytes() == ref_q.read_bytes(), kind
    ref_dec, our_dec = tmp_path / "ref.dec", tmp_path / "our.dec"
    assert subprocess.run([str(ref_bin), "-x", str(ref_q),
                           str(ref_dec)]).returncode == 0
    assert cli.main(["qvz", "-x", str(our_q), str(our_dec)]) == 0
    assert our_dec.read_bytes() == ref_dec.read_bytes()


@pytest.mark.parametrize("n,cols", [(50, 1), (30, 1022), (1, 20), (2, 5)])
def test_extreme_geometry_parity(ref_bin, tmp_path, n, cols):
    """Format-envelope corners: single column, the 1022-column cap
    (lines.h:13), single-line and two-line files."""
    from qvz_tpu import cli

    inp = tmp_path / "in.qual"
    synth_file(inp, n, cols, seed=n * 1000 + cols)
    ref_q, our_q = tmp_path / "ref.q", tmp_path / "our.q"
    r = subprocess.run([str(ref_bin), "-f", "0.5", "-s", str(inp),
                        str(ref_q)], capture_output=True)
    assert r.returncode == 0, (r.stdout, r.stderr)
    assert cli.main(["qvz", "-f", "0.5", "--debug-seed", "--no-jax",
                     str(inp), str(our_q)]) == 0
    assert our_q.read_bytes() == ref_q.read_bytes()

    ref_dec, our_dec = tmp_path / "ref.dec", tmp_path / "our.dec"
    assert cli.main(["qvz", "-x", str(our_q), str(our_dec)]) == 0
    if cols == 1:
        # the reference DECODER segfaults on single-column files (its
        # encoder works); gate ours on the encoder's own reconstruction
        our_u, our_q2 = tmp_path / "our.u", tmp_path / "our2.q"
        assert cli.main(["qvz", "-f", "0.5", "--debug-seed", "--no-jax",
                         "-u", str(our_u), str(inp), str(our_q2)]) == 0
        assert our_dec.read_bytes() == our_u.read_bytes()
        return
    assert subprocess.run([str(ref_bin), "-x", str(ref_q),
                           str(ref_dec)]).returncode == 0
    assert our_dec.read_bytes() == ref_dec.read_bytes()


def test_rd_sweep_bit_parity(ref_bin, tmp_path):
    """Full generate_rd.sh protocol (generate_rd.sh:4-16): all 20 rate
    points -f 0.00..0.95 step 0.05, containers byte-equal to the
    reference at EVERY point."""
    from qvz_tpu import cli

    inp = tmp_path / "rd.qual"
    synth_file(inp, 2000, 36, 505)
    for i in range(20):
        f = f"{i * 0.05:.2f}"
        ref_q = tmp_path / f"ref_{f}.q"
        our_q = tmp_path / f"our_{f}.q"
        r = subprocess.run([str(ref_bin), "-f", f, "-c", "1", "-s",
                            str(inp), str(ref_q)], capture_output=True)
        assert r.returncode == 0, (f, r.stderr)
        assert cli.main(["qvz", "-f", f, "-c", "1", "--debug-seed",
                         "--no-jax", str(inp), str(our_q)]) == 0
        assert our_q.read_bytes() == ref_q.read_bytes(), \
            f"R-D sweep divergence at -f {f}"
        # decoded output parity closes the loop at a few points
        if i in (0, 10, 19):
            ref_d = tmp_path / f"ref_{f}.dec"
            our_d = tmp_path / f"our_{f}.dec"
            r = subprocess.run([str(ref_bin), "-x", str(ref_q),
                                str(ref_d)], capture_output=True)
            assert r.returncode == 0
            assert cli.main(["qvz", "-x", str(our_q), str(our_d)]) == 0
            assert our_d.read_bytes() == ref_d.read_bytes()


def test_transcoded_v2_to_v1_decodes_with_reference(ref_bin, tmp_path):
    """Interop: a QVZ2 archive transcoded to v1 (tools/transcode, no
    re-quantization) must be decodable by the reference C binary, with
    output equal to our own decode of the QVZ2 original."""
    from qvz_tpu import cli
    from qvz_tpu.tools.transcode import transcode

    inp = tmp_path / "in.qual"
    synth_file(inp, 1200, 40, 909)
    v2 = tmp_path / "a.v2.q"
    assert cli.main(["qvz", "-f", "0.5", "-c", "2", "--debug-seed",
                     "--no-jax", "--shards", "3", str(inp),
                     str(v2)]) == 0
    v1 = tmp_path / "a.v1.q"
    transcode(str(v2), str(v1), "v1")

    ref_dec = tmp_path / "ref.dec"
    r = subprocess.run([str(ref_bin), "-x", str(v1), str(ref_dec)],
                       capture_output=True)
    assert r.returncode == 0, r.stderr
    our_dec = tmp_path / "our.dec"
    assert cli.main(["qvz", "-x", str(v2), str(our_dec)]) == 0
    assert ref_dec.read_bytes() == our_dec.read_bytes()


# Device-lane fuzz: the device encode path is fuzzed against the
# reference, not just the host coder. Each config runs the full device
# encode path — quantize scan + lane coder scan on the forced-CPU XLA
# backend (the on-card run is chip_smoke.py) — and checks three edges:
# device QVZ2 container == host QVZ2 container, -u reconstruction ==
# the reference binary's, and our decode of the device container ==
# the reference's decode of its own v1 container.
DEVICE_FUZZ = [
    (["-r", "1.3", "-c", "2", "-d", "L"], 500, 41, 202),
    (["-f", "0.8", "-c", "4", "-d", "A", "-T", "2"], 600, 30, 303),
    (["-f", "0.95", "-c", "1", "-d", "M"], 400, 52, 707),
]


@pytest.mark.parametrize("flags,n,cols,seed", DEVICE_FUZZ)
def test_device_lane_fuzz_vs_reference(ref_bin, tmp_path, flags, n,
                                       cols, seed, monkeypatch):
    from qvz_tpu import cli

    inp = tmp_path / "in.qual"
    synth_file(inp, n, cols, seed)

    ref_q, ref_u = tmp_path / "ref.q", tmp_path / "ref.u"
    ref_dec = tmp_path / "ref.dec"
    r = subprocess.run([str(ref_bin), *flags, "-u", str(ref_u),
                        str(inp), str(ref_q)], capture_output=True)
    assert r.returncode == 0, r.stderr
    assert subprocess.run([str(ref_bin), "-x", str(ref_q),
                           str(ref_dec)]).returncode == 0

    host_q = tmp_path / "host.q"
    assert cli.main(["qvz", *flags, "--debug-seed", "--no-jax",
                     "--shards", "3", str(inp), str(host_q)]) == 0

    dev_q, dev_u = tmp_path / "dev.q", tmp_path / "dev.u"
    assert cli.main(["qvz", *flags, "--debug-seed", "--jax", "-u",
                     str(dev_u), "--shards", "3", str(inp),
                     str(dev_q)]) == 0

    assert dev_q.read_bytes() == host_q.read_bytes()
    assert dev_u.read_bytes() == ref_u.read_bytes()

    dev_dec = tmp_path / "dev.dec"
    assert cli.main(["qvz", "-x", str(dev_q), str(dev_dec)]) == 0
    assert dev_dec.read_bytes() == ref_dec.read_bytes()


def test_verbose_stdout_matches_reference(ref_bin, tmp_path, capfd):
    """-v stdout parity: the k-means
    iteration prints (cluster.c:126-127, 236-243), seed prints
    (cluster.c:202-204), preamble (main.c:311-340) and summary
    (main.c:98-121) must match the reference line-for-line, excluding
    only timing values (and our documented finer-grained phase lines)."""
    import re

    from qvz_tpu import cli

    inp = tmp_path / "in.qual"
    synth_file(inp, 2500, 28, 515)

    ref_q = tmp_path / "ref.q"
    r = subprocess.run([str(ref_bin), "-f", "0.4", "-c", "3", "-v",
                        str(inp), str(ref_q)], capture_output=True,
                       text=True)
    assert r.returncode == 0, r.stderr

    our_q = tmp_path / "our.q"
    capfd.readouterr()
    assert cli.main(["qvz", "-f", "0.4", "-c", "3", "-v",
                     "--debug-seed", "--no-jax", str(inp),
                     str(our_q)]) == 0
    ours = capfd.readouterr().out

    def filt(text, out_name):
        return [ln.replace(out_name, "OUT") for ln in text.splitlines()
                if not re.search(r"seconds|^  \w+: ", ln)]

    assert filt(ours, str(our_q)) == filt(r.stdout, str(ref_q))
