"""Bounded-memory streaming encode: byte-identical container to the
in-memory pipeline for the same shard plan, across cluster counts and
priming modes."""

import numpy as np
import pytest

from qvz_tpu.constants import DISTORTION_MSE
from qvz_tpu.ops.distortion import make_matrix
from qvz_tpu.ops.well import WellState
from qvz_tpu.pipeline import decode as dec_mod
from qvz_tpu.pipeline import encode as enc_mod
from qvz_tpu.pipeline.streaming import encode_streaming


@pytest.fixture(scope="module")
def qfile(tmp_path_factory):
    rng = np.random.default_rng(77)
    n, cols = 30000, 40
    start = rng.integers(20, 45, size=(n, 1))
    steps = rng.integers(-3, 4, size=(n, cols - 1))
    data = np.clip(np.concatenate([start, steps], 1).cumsum(1), 0,
                   71).astype(np.uint8)
    out = np.empty((n, cols + 1), dtype=np.uint8)
    out[:, :cols] = data + 33
    out[:, cols] = 10
    path = tmp_path_factory.mktemp("st") / "st.in"
    path.write_bytes(out.tobytes())
    return str(path), data


@pytest.mark.parametrize("n_clusters,prime", [(1, True), (1, False),
                                              (3, True)])
def test_streaming_byte_equal(qfile, tmp_path, n_clusters, prime):
    path, data = qfile
    dist = make_matrix(DISTORTION_MSE)
    mem = enc_mod.encode(data, dist, n_clusters=n_clusters, ratio=0.5,
                         well_state=WellState.debug(), use_jax=False,
                         shards=5, want_recon=False, prime=prime)
    out_path = tmp_path / f"s{n_clusters}{prime}.q"
    st = encode_streaming(path, str(out_path), n_clusters=n_clusters,
                          ratio=0.5, well_state=WellState.debug(),
                          dist_matrix=dist, shards=5, prime=prime,
                          chunk_lines=7000)  # force multiple chunks
    assert out_path.read_bytes() == mem.compressed
    assert abs(st["rate"] - mem.stats.rate) < 1e-12
    assert abs(st["distortion"] - mem.stats.distortion) < 1e-9


def test_streaming_roundtrip(qfile, tmp_path):
    path, data = qfile
    dist = make_matrix(DISTORTION_MSE)
    out_path = tmp_path / "rt.q"
    encode_streaming(path, str(out_path), ratio=0.5,
                     well_state=WellState.debug(), dist_matrix=dist,
                     shards=4, chunk_lines=9000)
    mem = enc_mod.encode(data, dist, ratio=0.5,
                         well_state=WellState.debug(), use_jax=False,
                         shards=4, want_recon=True)
    dec = dec_mod.decode(out_path.read_bytes())
    assert np.array_equal(dec[:, :data.shape[1]], mem.reconstructed + 33)


def test_streaming_recon_u(qfile, tmp_path):
    """-u in the streaming path: the memmapped reconstruction file must
    be byte-equal to the in-memory path's."""
    from qvz_tpu.spec.pipeline import lines_to_bytes

    path, data = qfile
    dist = make_matrix(DISTORTION_MSE)
    out_path = tmp_path / "u.q"
    recon_path = tmp_path / "u.txt"
    encode_streaming(path, str(out_path), ratio=0.5,
                     well_state=WellState.debug(), dist_matrix=dist,
                     shards=4, recon_path=str(recon_path),
                     chunk_lines=9000)
    mem = enc_mod.encode(data, dist, ratio=0.5,
                         well_state=WellState.debug(), use_jax=False,
                         shards=4, want_recon=True)
    assert out_path.read_bytes() == mem.compressed
    assert recon_path.read_bytes() == lines_to_bytes(mem.reconstructed)


def test_parse_payload_limit(qfile, tmp_path):
    """Directory parse from a prefix of a big container: payload extents
    validate against the real file size (the multihost 1 MB
    header fast path must not force a full in-memory copy)."""
    from qvz_tpu.format import container_v2
    from qvz_tpu.native import runtime as rt

    path, data = qfile
    dist = make_matrix(DISTORTION_MSE)
    mem = enc_mod.encode(data, dist, ratio=0.5,
                         well_state=WellState.debug(), use_jax=False,
                         shards=5, want_recon=False)
    comp = mem.compressed
    head = container_v2.parse(comp, blocks_len=None)
    tables = rt.tables_from_blocks(comp[container_v2.header_size():],
                                   head.cluster_count, head.columns)
    full = container_v2.parse(comp, blocks_len=tables.consumed)
    # a prefix that covers the directory but NOT the payloads
    dir_end = full.shards[0].payload_off
    prefix = comp[:dir_end + 16]  # only 16 payload bytes present
    parsed = container_v2.parse(prefix, blocks_len=tables.consumed,
                                payload_limit=len(comp))
    assert [(s.payload_off, s.payload_len) for s in parsed.shards] == \
        [(s.payload_off, s.payload_len) for s in full.shards]
    # without the limit the same prefix must still be rejected
    with pytest.raises(ValueError, match="short payload"):
        container_v2.parse(prefix, blocks_len=tables.consumed)


def test_streaming_reuse_books(qfile, tmp_path):
    """Checkpoint/resume in the streaming path: reusing a previous
    container's codebooks skips stats+design and yields the same
    container as a fresh encode (same data, same books)."""
    path, data = qfile
    dist = make_matrix(DISTORTION_MSE)
    p1 = tmp_path / "a.q"
    encode_streaming(path, str(p1), ratio=0.5,
                     well_state=WellState.debug(), dist_matrix=dist,
                     shards=4)
    from qvz_tpu.format import container_v2
    comp = p1.read_bytes()
    blocks = comp[container_v2.header_size():]
    p2 = tmp_path / "b.q"
    st = encode_streaming(path, str(p2), ratio=0.5,
                          well_state=WellState.debug(),
                          dist_matrix=dist, shards=4,
                          reuse_blocks=blocks)
    assert st["stats_s"] == 0.0
    assert p2.read_bytes() == comp


def test_streaming_device_path_byte_equal(qfile, tmp_path):
    """use_jax=True streaming (device chunked stats + per-shard device
    quantize, host adaptive streams) emits the same container bytes and
    -u reconstruction as the host streaming path (the
    device passes wired into the bounded-RSS pipeline)."""
    path, data = qfile
    dist = make_matrix(DISTORTION_MSE)
    host_q = tmp_path / "h.q"
    host_u = tmp_path / "h.u"
    dev_q = tmp_path / "d.q"
    dev_u = tmp_path / "d.u"
    for n_clusters in (1, 3):
        encode_streaming(path, str(host_q), n_clusters=n_clusters,
                         ratio=0.5, well_state=WellState.debug(),
                         dist_matrix=dist, shards=5, chunk_lines=7000,
                         recon_path=str(host_u))
        st = encode_streaming(path, str(dev_q), n_clusters=n_clusters,
                              ratio=0.5, well_state=WellState.debug(),
                              dist_matrix=dist, shards=5,
                              chunk_lines=7000, recon_path=str(dev_u),
                              use_jax=True)
        assert dev_q.read_bytes() == host_q.read_bytes()
        assert dev_u.read_bytes() == host_u.read_bytes()
        assert st["payload_bytes"] > 0
