"""Multi-host driver determinism: N worker processes must produce a
container byte-equal to the single-process QVZ2 encode (SURVEY §2b
item 3 — the distributed replacement for the single-process loop
qv_compressor.c:48-143)."""

import numpy as np
import pytest

from qvz_tpu.constants import DISTORTION_MSE
from qvz_tpu.ops.distortion import make_matrix
from qvz_tpu.ops.well import WellState
from qvz_tpu.parallel.multihost import encode_multihost
from qvz_tpu.pipeline import decode as dec_mod
from qvz_tpu.pipeline import encode as enc_mod


@pytest.fixture(scope="module")
def qfile(tmp_path_factory):
    rng = np.random.default_rng(31)
    n, cols = 6000, 48
    start = rng.integers(20, 45, size=(n, 1))
    steps = rng.integers(-3, 4, size=(n, cols - 1))
    data = np.clip(np.concatenate([start, steps], 1).cumsum(1), 0,
                   71).astype(np.uint8)
    out = np.empty((n, cols + 1), dtype=np.uint8)
    out[:, :cols] = data + 33
    out[:, cols] = 10
    path = tmp_path_factory.mktemp("mh") / "mh.in"
    path.write_bytes(out.tobytes())
    return str(path), data


@pytest.mark.parametrize("n_clusters", [1, 3])
@pytest.mark.parametrize("n_hosts", [2, 4])
def test_multihost_byte_equal(qfile, n_hosts, n_clusters):
    path, data = qfile
    dist = make_matrix(DISTORTION_MSE)
    shards = 6

    single = enc_mod.encode(data, dist, n_clusters=n_clusters, ratio=0.5,
                            well_state=WellState.debug(), use_jax=False,
                            shards=shards, want_recon=False)
    multi, stats = encode_multihost(
        path, n_hosts=n_hosts, shards=shards, n_clusters=n_clusters,
        ratio=0.5, well_state=WellState.debug(), dist_matrix=dist)

    assert multi == single.compressed, (
        f"{n_hosts}-host container differs from single-process")
    assert stats["hosts"] == n_hosts
    assert abs(stats["rate"] - single.stats.rate) < 1e-12
    assert abs(stats["distortion"] - single.stats.distortion) < 1e-9


def test_multihost_decode_roundtrip(qfile):
    path, data = qfile
    dist = make_matrix(DISTORTION_MSE)
    multi, _ = encode_multihost(path, n_hosts=3, shards=5, n_clusters=2,
                                ratio=0.5, well_state=WellState.debug(),
                                dist_matrix=dist)
    ref = enc_mod.encode(data, dist, n_clusters=2, ratio=0.5,
                         well_state=WellState.debug(), use_jax=False,
                         shards=5, want_recon=True)
    out = dec_mod.decode(multi)
    assert np.array_equal(out[:, :data.shape[1]], ref.reconstructed + 33)


@pytest.mark.parametrize("n_hosts", [2, 3])
def test_multihost_decode_byte_equal(qfile, tmp_path, n_hosts):
    """Distributed decode: N processes pwriting slices must reproduce
    the single-process decode byte-for-byte (primed container)."""
    from qvz_tpu.parallel.multihost import decode_multihost
    from qvz_tpu.spec.pipeline import lines_to_bytes

    path, data = qfile
    dist = make_matrix(DISTORTION_MSE)
    out = enc_mod.encode(data, dist, n_clusters=2, ratio=0.5,
                         well_state=WellState.debug(), use_jax=False,
                         shards=5, want_recon=False)
    cpath = tmp_path / "c.q"
    cpath.write_bytes(out.compressed)
    single = dec_mod.decode(out.compressed)

    opath = tmp_path / f"mh{n_hosts}.dec"
    nl = decode_multihost(str(cpath), str(opath), n_hosts=n_hosts)
    assert nl == data.shape[0]
    assert opath.read_bytes() == single.tobytes()


def test_multihost_recon_file(qfile, tmp_path):
    """-u under --hosts: the multi-host reconstruction side-file must
    byte-equal the single-process one
    (reference writes it in every encode mode, qv_compressor.c:100-103;
    here workers memmap-write their row ranges)."""
    from qvz_tpu.spec.pipeline import lines_to_bytes

    path, data = qfile
    dist = make_matrix(DISTORTION_MSE)
    single = enc_mod.encode(data, dist, n_clusters=2, ratio=0.5,
                            well_state=WellState.debug(), use_jax=False,
                            shards=5, want_recon=True)
    rpath = tmp_path / "mh.recon"
    multi, _ = encode_multihost(
        path, n_hosts=3, shards=5, n_clusters=2, ratio=0.5,
        well_state=WellState.debug(), dist_matrix=dist,
        recon_path=str(rpath))
    assert multi == single.compressed
    assert rpath.read_bytes() == lines_to_bytes(single.reconstructed)


@pytest.mark.parametrize("n_clusters", [1, 2])
def test_multihost_streaming_byte_equal(qfile, tmp_path, n_clusters):
    """streaming x multihost composition: workers
    stream their row ranges in small chunks (chunked k-means + stats,
    per-shard materialization, payload spill files) and the coordinator
    assembles the container straight to disk — byte-identical to the
    in-memory multihost encode AND the single-process encode, with the
    -u reconstruction also byte-equal."""
    from qvz_tpu.spec.pipeline import lines_to_bytes

    path, data = qfile
    dist = make_matrix(DISTORTION_MSE)

    single = enc_mod.encode(data, dist, n_clusters=n_clusters, ratio=0.5,
                            well_state=WellState.debug(), use_jax=False,
                            shards=5, want_recon=True)
    rpath = tmp_path / "mhs.recon"
    opath = tmp_path / "mhs.q"
    comp, stats = encode_multihost(
        path, n_hosts=3, shards=5, n_clusters=n_clusters, ratio=0.5,
        well_state=WellState.debug(), dist_matrix=dist,
        streaming=True, chunk_lines=700,  # force many chunk passes
        output_path=str(opath), recon_path=str(rpath))
    assert comp is None
    assert opath.read_bytes() == single.compressed
    assert rpath.read_bytes() == lines_to_bytes(single.reconstructed)
    assert abs(stats["rate"] - single.stats.rate) < 1e-12


# ---------------------------------------------------------------------------
# Chaos tests: a >=1 GB --hosts 2 --streaming encode
# must fail CLEAN — actionable error, no partial container, no leaked
# spill files — under an injected worker death and an injected truncated
# shard payload. The reference has no failure detection at all (errors
# are printf+exit, SURVEY §5); parse-time checksums already guard decode,
# and these prove the ENCODE control plane end-to-end.


@pytest.fixture(scope="module")
def bigfile(tmp_path_factory):
    """~1.02 GB quality file (10M lines x 101 cols), built by tiling a
    1M-line random block (content repetition is irrelevant to the
    control-plane failure paths under test). Deleted at module end."""
    rng = np.random.default_rng(77)
    n_block, cols = 1_000_000, 101
    start = rng.integers(25, 42, size=(n_block, 1))
    steps = rng.integers(-2, 3, size=(n_block, cols - 1))
    data = np.clip(np.concatenate([start, steps], 1).cumsum(1), 2,
                   41).astype(np.uint8)
    block = np.empty((n_block, cols + 1), dtype=np.uint8)
    block[:, :cols] = data + 33
    block[:, cols] = 10
    path = tmp_path_factory.mktemp("chaos") / "big.in"
    with open(path, "wb") as f:
        for _ in range(10):
            f.write(block.tobytes())
    assert path.stat().st_size >= 1_000_000_000
    yield str(path)
    path.unlink(missing_ok=True)


def _no_spill_leak(out_dir):
    import glob
    import os
    leaks = glob.glob(os.path.join(out_dir, "qvz_mh_spill_*"))
    assert leaks == [], f"leaked spill dirs: {leaks}"


def test_chaos_worker_death_fails_clean(bigfile, tmp_path, monkeypatch):
    """Kill worker 1 when the coding phase starts: the coordinator must
    raise an actionable error (who died, which phase) and write NO
    container file."""
    monkeypatch.setenv("QVZ_MH_CHAOS", "die_on_encode")
    opath = tmp_path / "dead.q"
    with pytest.raises(RuntimeError, match=r"worker 1 .*coding.*exit "
                                           r"code 17"):
        encode_multihost(bigfile, n_hosts=2, streaming=True,
                         chunk_lines=1_000_000, ratio=0.5,
                         well_state=WellState.debug(),
                         output_path=str(opath))
    assert not opath.exists(), "partial container left behind"
    _no_spill_leak(str(tmp_path))


def test_chaos_truncated_spill_fails_clean(bigfile, tmp_path,
                                           monkeypatch):
    """Worker 1 ships a spill file 64 bytes shorter than its directory
    entries claim: the coordinator must detect the mismatch BEFORE
    assembling and write NO container file."""
    monkeypatch.setenv("QVZ_MH_CHAOS", "truncate_spill")
    opath = tmp_path / "trunc.q"
    with pytest.raises(ValueError, match="truncated/corrupt payload"):
        encode_multihost(bigfile, n_hosts=2, streaming=True,
                         chunk_lines=1_000_000, ratio=0.5,
                         well_state=WellState.debug(),
                         output_path=str(opath))
    assert not opath.exists(), "partial container left behind"
    _no_spill_leak(str(tmp_path))
