"""Device (lane-parallel) arithmetic encoder: byte-identical QVZ2
containers vs the host coder across configs, plus exactness unit tests
for the no-64-bit division and the replay feeder.

Here the XLA scan runs on the forced-CPU backend (conftest), which
shares the HLO-level integer semantics; chip_smoke.py runs the same
path on the card."""

import os

import numpy as np
import pytest

from qvz_tpu.constants import DISTORTION_MSE
from qvz_tpu.ops.distortion import make_matrix
from qvz_tpu.ops.well import WellState
from qvz_tpu.pipeline import encode as enc_mod


def _mkdata(n, cols, seed=7):
    rng = np.random.default_rng(seed)
    start = rng.integers(20, 45, size=(n, 1))
    steps = rng.integers(-3, 4, size=(n, cols - 1))
    return np.clip(np.concatenate([start, steps], 1).cumsum(1), 0,
                   71).astype(np.uint8)


def _encode(data, *, use_jax, **kw):
    dist = make_matrix(DISTORTION_MSE)
    return enc_mod.encode(data, dist, well_state=WellState.debug(),
                          use_jax=use_jax, **kw)


def test_exact_div_exhaustive_random():
    """floor(range*cum/n) without 64-bit math: the f32 estimate + u32
    remainder fixup must be exact over the full operand envelope
    (range < 2^22, 0 <= cum <= n <= 2^19 + 8)."""
    import jax
    import jax.numpy as jnp

    from qvz_tpu.ops.coder_device import _exact_div

    rng = np.random.default_rng(0)
    m = 200_000
    n = rng.integers(1, (1 << 19) + 9, size=m).astype(np.uint32)
    cum = (rng.random(m) * (n + 1)).astype(np.uint32)
    cum = np.minimum(cum, n)
    r = rng.integers(1 << 20, 1 << 22, size=m).astype(np.uint32)
    # adversarial corner: cum == n, cum == n-1, tiny n
    n[:100] = 1
    cum[:100] = 1
    cum[100:200] = n[100:200]
    cum[200:300] = np.maximum(n[200:300].astype(np.int64) - 1,
                              0).astype(np.uint32)
    got = np.asarray(jax.jit(_exact_div)(jnp.asarray(r), jnp.asarray(cum),
                                         jnp.asarray(n)))
    want = (r.astype(np.uint64) * cum.astype(np.uint64)
            // n.astype(np.uint64)).astype(np.uint32)
    assert np.array_equal(got, want)


def test_replay_model_matches_bruteforce():
    from qvz_tpu.native import runtime as rt

    rng = np.random.default_rng(3)
    card = 5
    syms = rng.integers(0, card, size=70_000).astype(np.uint8)
    init = np.ones(card, dtype=np.uint32)
    out = rt.replay_model(init, card, syms)
    # brute-force oracle incl. rescale (qv_stream.c:9-25)
    c = init.astype(np.int64).copy()
    total = card
    R = 1 << 19
    for i, x in enumerate(syms[:70_000]):
        assert out[i, 0] == c[:x].sum()
        assert out[i, 1] == c[: x + 1].sum()
        assert out[i, 2] == total
        c[x] += 8
        t = total + 8
        if t > R:
            t = 0
            for k in range(card):
                if c[k]:
                    c[k] = (c[k] >> 1) + 1
                    t += c[k]
        total = t
    assert total > R // 4  # the replay crossed at least one rescale


CONFIGS = [
    dict(ratio=0.5, n_clusters=1, shards=4, prime=True),
    dict(ratio=0.5, n_clusters=1, shards=4, prime=False),
    dict(ratio=0.2, n_clusters=1, shards=3, prime=True),
    dict(ratio=0.8, n_clusters=1, shards=6, prime=True),
    dict(ratio=0.5, n_clusters=3, shards=4, prime=True),
    dict(ratio=0.9, n_clusters=2, shards=5, prime=False),
]


@pytest.mark.parametrize("cfg", CONFIGS)
def test_device_coder_byte_equal(cfg):
    """The device-coder container must be byte-identical to the host
    path for the same shard plan."""
    data = _mkdata(4000, 24, seed=11)
    host = _encode(data, use_jax=False, **cfg)
    os.environ["QVZ_TPU_DEVICE_MIN_BYTES"] = "0"
    os.environ["QVZ_TPU_DEVICE_CODER"] = "1"
    try:
        dev = _encode(data, use_jax=True, **cfg)
    finally:
        del os.environ["QVZ_TPU_DEVICE_MIN_BYTES"]
        del os.environ["QVZ_TPU_DEVICE_CODER"]
    assert dev.compressed == host.compressed
    assert abs(dev.stats.distortion - host.stats.distortion) < 1e-3


def test_device_coder_ragged_last_shard():
    data = _mkdata(4001, 16, seed=5)  # last lane shorter -> padding
    host = _encode(data, use_jax=False, shards=5)
    os.environ["QVZ_TPU_DEVICE_MIN_BYTES"] = "0"
    try:
        dev = _encode(data, use_jax=True, shards=5)
    finally:
        del os.environ["QVZ_TPU_DEVICE_MIN_BYTES"]
    assert dev.compressed == host.compressed


def test_device_coder_rescale_fallback():
    """A shard long enough to rescale a column model must be flagged
    and host-coded — container still byte-identical."""
    rng = np.random.default_rng(1)
    # 2 columns, near-constant symbols => one model sees ~every line.
    # A model needs > 65536 occurrences to overflow r = 2^19; the
    # dither splits a column's lines between the lo/hi choice models,
    # so 300k lines / 2 shards = 150k per lane ~> 75k per choice.
    n = 300_000
    data = np.clip(30 + rng.integers(-1, 2, size=(n, 2)).cumsum(1), 0,
                   71).astype(np.uint8)
    host = _encode(data, use_jax=False, shards=2, prime=False)
    os.environ["QVZ_TPU_DEVICE_MIN_BYTES"] = "0"
    try:
        dev = _encode(data, use_jax=True, shards=2, prime=False)
    finally:
        del os.environ["QVZ_TPU_DEVICE_MIN_BYTES"]
    assert dev.compressed == host.compressed
    assert dev.stats.coder_fallback_lanes >= 1


def test_device_coder_decodes():
    from qvz_tpu.pipeline import decode as dec_mod

    data = _mkdata(3000, 20, seed=9)
    os.environ["QVZ_TPU_DEVICE_MIN_BYTES"] = "0"
    try:
        dev = _encode(data, use_jax=True, shards=4, want_recon=True)
    finally:
        del os.environ["QVZ_TPU_DEVICE_MIN_BYTES"]
    out = dec_mod.decode(dev.compressed)
    assert np.array_equal(out[:, :20], dev.reconstructed + 33)


def test_device_coder_clusters_byte_equal():
    """Device coder with a cluster-id segment (explicit host-replayed
    triples ahead of the column steps): container byte-identical to
    the host coder."""
    data = _mkdata(3000, 20, seed=3)
    cfg = dict(shards=4, n_clusters=2)
    host = _encode(data, use_jax=False, **cfg)
    dev = _encode(data, use_jax=True, **cfg)
    assert dev.compressed == host.compressed
    assert dev.stats.coder_fallback_lanes == 0


def test_device_coder_many_lanes():
    """130 lanes of 32 lines: wider than any one lane tile, so the
    lane layout and per-lane payload assembly see many lanes."""
    data = _mkdata(4096, 8, seed=11)
    cfg = dict(shards=130, prime=False)
    host = _encode(data, use_jax=False, **cfg)
    dev = _encode(data, use_jax=True, **cfg)
    assert dev.compressed == host.compressed


def _low_entropy(seed, n=4000, cols=12):
    rng = np.random.default_rng(seed)
    return np.clip(30 + rng.integers(-1, 2, size=(n, cols)).cumsum(1),
                   0, 71).astype(np.uint8)


@pytest.mark.parametrize("prime", [True, False])
def test_device_coder_low_entropy_byte_equal(prime):
    """Low-entropy data (near-constant columns): the same model recurs
    step after step, so the carried occurrence counts grow fastest.
    Plus a cluster segment; primed and unprimed banks."""
    data = _low_entropy(21)
    cfg = dict(shards=4, n_clusters=2, prime=prime)
    host = _encode(data, use_jax=False, **cfg)
    dev = _encode(data, use_jax=True, **cfg)
    assert dev.compressed == host.compressed


@pytest.mark.parametrize("ratio", [0.3, 0.9])
def test_device_coder_low_entropy_three_clusters(ratio):
    """Three clusters over low-entropy data at a low and a high rate
    (few vs many slots per column), priming on."""
    data = _low_entropy(33)
    cfg = dict(shards=5, n_clusters=3, ratio=ratio)
    host = _encode(data, use_jax=False, **cfg)
    dev = _encode(data, use_jax=True, **cfg)
    assert dev.compressed == host.compressed
