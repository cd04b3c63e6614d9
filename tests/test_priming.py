"""QVZ2 shard priming: shards 1..N-1 start
from the warmup shard's model-bank state — derived identically by
encoder and decoder, zero container bytes. Rate overhead vs v1 drops
from ~0.7% to <0.1% at the bench shard geometry; reconstruction is
invariant (priming touches only entropy coding)."""

import numpy as np
import pytest

from qvz_tpu.constants import DISTORTION_MSE
from qvz_tpu.format import container_v2
from qvz_tpu.ops.distortion import make_matrix
from qvz_tpu.ops.well import WellState
from qvz_tpu.pipeline import decode as dec_mod
from qvz_tpu.pipeline import encode as enc_mod


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(41)
    n, cols = 40000, 50
    start = rng.integers(20, 45, size=(n, 1))
    steps = rng.integers(-3, 4, size=(n, cols - 1))
    return np.clip(np.concatenate([start, steps], 1).cumsum(1), 0,
                   71).astype(np.uint8)


@pytest.fixture(scope="module")
def dist():
    return make_matrix(DISTORTION_MSE)


@pytest.mark.parametrize("n_clusters", [1, 2])
def test_priming_rate_and_invariance(data, dist, n_clusters):
    kw = dict(n_clusters=n_clusters, ratio=0.5,
              well_state=WellState.debug(), use_jax=False)
    v1 = enc_mod.encode(data, dist, shards=1, **kw)
    un = enc_mod.encode(data, dist, shards=4, prime=False, **kw)
    pr = enc_mod.encode(data, dist, shards=4, prime=True, **kw)

    # priming must recover most of the restart overhead (at this small
    # 40k-line geometry the warmup is only ~5k lines; the <0.1% target
    # holds at bench scale with the 64k warmup — see SCALING.md)
    over_un = un.stats.rate / v1.stats.rate - 1
    over_pr = pr.stats.rate / v1.stats.rate - 1
    assert over_pr < over_un / 3
    assert over_pr < 0.012

    # reconstruction identical across all three modes
    assert np.array_equal(v1.reconstructed, un.reconstructed)
    assert np.array_equal(v1.reconstructed, pr.reconstructed)

    # container says priming; round-trip decodes to the reconstruction
    head = container_v2.parse(pr.compressed, blocks_len=None)
    assert head.priming == 1
    out = dec_mod.decode(pr.compressed)
    assert np.array_equal(out[:, :data.shape[1]], v1.reconstructed + 33)


def test_priming_device_path_byte_equal(data, dist):
    kw = dict(n_clusters=1, ratio=0.5, well_state=WellState.debug(),
              shards=4, want_recon=False)
    host = enc_mod.encode(data, dist, use_jax=False, **kw)
    dev = enc_mod.encode(data, dist, use_jax=True, **kw)
    assert host.compressed == dev.compressed


def test_priming_multihost_byte_equal(data, dist, tmp_path):
    from qvz_tpu.parallel.multihost import encode_multihost
    from qvz_tpu.spec.pipeline import lines_to_bytes

    path = tmp_path / "p.in"
    path.write_bytes(lines_to_bytes(data))
    single = enc_mod.encode(data, dist, n_clusters=2, ratio=0.5,
                            well_state=WellState.debug(), use_jax=False,
                            shards=5, want_recon=False)
    head = container_v2.parse(single.compressed, blocks_len=None)
    assert head.priming == 1  # priming actually engaged
    multi, _ = encode_multihost(str(path), n_hosts=3, shards=5,
                                n_clusters=2, ratio=0.5,
                                well_state=WellState.debug(),
                                dist_matrix=dist)
    assert multi == single.compressed


def test_no_prime_shards_fully_independent(data, dist):
    """priming=0 shards decode standalone (random access); with priming
    the decoder takes the warmup stage path — both must round-trip."""
    kw = dict(n_clusters=1, ratio=0.5, well_state=WellState.debug(),
              use_jax=False, shards=3)
    un = enc_mod.encode(data, dist, prime=False, **kw)
    head = container_v2.parse(un.compressed, blocks_len=None)
    assert head.priming == 0
    out = dec_mod.decode(un.compressed)
    assert np.array_equal(out[:, :data.shape[1]], un.reconstructed + 33)
