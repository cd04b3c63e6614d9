"""Device (lane-parallel) arithmetic DECODER: output byte-identical to
the host decoder across configs, plus the exactness fallbacks.

Decode twin of test_coder_device.py — runs on the forced-CPU XLA
backend (conftest); chip_smoke.py runs the same path on the card."""

import numpy as np
import pytest

from qvz_tpu.constants import DISTORTION_MSE
from qvz_tpu.ops.distortion import make_matrix
from qvz_tpu.ops.well import WellState
from qvz_tpu.pipeline import decode as dec_mod
from qvz_tpu.pipeline import encode as enc_mod


def _mkdata(n, cols, seed=7):
    rng = np.random.default_rng(seed)
    start = rng.integers(20, 45, size=(n, 1))
    steps = rng.integers(-3, 4, size=(n, cols - 1))
    return np.clip(np.concatenate([start, steps], 1).cumsum(1), 0,
                   71).astype(np.uint8)


def _encode(data, **kw):
    dist = make_matrix(DISTORTION_MSE)
    return enc_mod.encode(data, dist, well_state=WellState.debug(),
                          use_jax=False, **kw)


CONFIGS = [
    dict(ratio=0.5, n_clusters=1, shards=4, prime=False),
    dict(ratio=0.2, n_clusters=1, shards=3, prime=False),
    dict(ratio=0.8, n_clusters=1, shards=6, prime=False),
    dict(ratio=0.5, n_clusters=3, shards=4, prime=False),
    dict(ratio=0.9, n_clusters=2, shards=5, prime=False),
]


@pytest.mark.parametrize("cfg", CONFIGS)
def test_device_decode_byte_equal(cfg):
    """decode(device=True) must reproduce the host decoder's bytes for
    every config (ROADMAP item 13: the last host-only phase)."""
    data = _mkdata(4000, 24, seed=11)
    comp = _encode(data, **cfg).compressed
    host = dec_mod.decode(comp)
    dev = dec_mod.decode(comp, device=True)
    assert np.array_equal(dev, host)


def test_device_decode_primed():
    """Priming engages above 2x the warmup size; lanes start from the
    warmup shard's bank (device icc tables derived from the same
    snapshot the host decoder loads)."""
    data = _mkdata(24000, 12, seed=2)
    comp = _encode(data, shards=4, prime=True).compressed
    from qvz_tpu.format import container_v2
    assert container_v2.parse(comp, blocks_len=None).priming
    host = dec_mod.decode(comp)
    dev = dec_mod.decode(comp, device=True)
    assert np.array_equal(dev, host)


def test_device_decode_primed_multicluster():
    data = _mkdata(24000, 12, seed=4)
    comp = _encode(data, shards=4, prime=True, n_clusters=3).compressed
    host = dec_mod.decode(comp)
    dev = dec_mod.decode(comp, device=True)
    assert np.array_equal(dev, host)


def test_device_decode_ragged_last_shard():
    data = _mkdata(4001, 16, seed=5)  # uneven split -> two lane groups
    comp = _encode(data, shards=5, prime=False).compressed
    host = dec_mod.decode(comp)
    dev = dec_mod.decode(comp, device=True)
    assert np.array_equal(dev, host)


def test_device_decode_single_column():
    data = _mkdata(3000, 1, seed=9)
    comp = _encode(data, shards=3, prime=False).compressed
    assert np.array_equal(dec_mod.decode(comp, device=True),
                          dec_mod.decode(comp))


def test_device_decode_rescale_fallback():
    """A shard long enough to rescale a live column model must be
    flagged and host-decoded — output still byte-identical (mirror of
    the encode-side test_device_coder_rescale_fallback)."""
    rng = np.random.default_rng(1)
    n = 300_000
    data = np.clip(30 + rng.integers(-1, 2, size=(n, 2)).cumsum(1), 0,
                   71).astype(np.uint8)
    comp = _encode(data, shards=2, prime=False).compressed
    host = dec_mod.decode(comp)

    from qvz_tpu.ops import decoder_device as dd

    flagged = []
    real = dd.decode_lanes

    def spy(*a, **k):
        qv, flags = real(*a, **k)
        flagged.append(int(flags.sum()))
        return qv, flags

    dd_decode_lanes = dd.decode_lanes
    dd.decode_lanes = spy
    # the pipeline imports decode_lanes inside the function, so the
    # module attribute swap is what it sees
    try:
        dev = dec_mod.decode(comp, device=True)
    finally:
        dd.decode_lanes = dd_decode_lanes
    assert np.array_equal(dev, host)
    assert sum(flagged) >= 1


def test_device_decode_env_knob(monkeypatch):
    data = _mkdata(2000, 10, seed=13)
    comp = _encode(data, shards=3, prime=False).compressed
    host = dec_mod.decode(comp)
    monkeypatch.setenv("QVZ_TPU_DEVICE_DECODE", "1")
    assert np.array_equal(dec_mod.decode(comp), host)


def test_device_decode_v1_container_unaffected():
    """v1 (single interleaved stream) has no shard lanes; device=True
    must silently use the host path."""
    data = _mkdata(1500, 10, seed=17)
    comp = _encode(data, shards=1).compressed
    assert np.array_equal(dec_mod.decode(comp, device=True),
                          dec_mod.decode(comp))


def test_mul64_20x22_exhaustive_random():
    """The 42-bit product split must be exact over the full operand
    envelope (a < 2^20, b <= 2^22)."""
    import jax
    import jax.numpy as jnp

    from qvz_tpu.ops.decoder_device import _mul64_20x22

    rng = np.random.default_rng(0)
    m = 200_000
    a = rng.integers(0, 1 << 20, size=m).astype(np.uint32)
    b = rng.integers(0, (1 << 22) + 1, size=m).astype(np.uint32)
    a[:10] = (1 << 20) - 1
    b[:10] = 1 << 22
    hi, lo = jax.jit(_mul64_20x22)(jnp.asarray(a), jnp.asarray(b))
    want = a.astype(np.uint64) * b.astype(np.uint64)
    got = (np.asarray(hi).astype(np.uint64) << 32) | np.asarray(lo)
    assert np.array_equal(got, want)


def _spy_decode_lanes(monkeypatch):
    from qvz_tpu.ops import decoder_device as dd

    shapes = []
    real = dd.decode_lanes

    def spy(dplan, payloads, draws, cl, states, **k):
        shapes.append(draws.shape)
        return real(dplan, payloads, draws, cl, states, **k)

    monkeypatch.setattr(dd, "decode_lanes", spy)
    return shapes


def test_device_decode_prologue_ragged(monkeypatch):
    """A cluster prologue with a non-trivial bit-offset takeover state
    and a ragged last lane (its own lane group): output byte-identical
    to the host decoder."""
    shapes = _spy_decode_lanes(monkeypatch)
    data = _mkdata(4001, 14, seed=23)  # 5 shards -> ragged last lane
    comp = _encode(data, shards=5, n_clusters=2, prime=False).compressed
    host = dec_mod.decode(comp)
    dev = dec_mod.decode(comp, device=True)
    assert np.array_equal(dev, host)
    assert len(shapes) == 2, shapes


def test_device_decode_primed_16_lanes(monkeypatch):
    """Primed lanes: the init-count tables derive from the warmup
    bank, and every lane's takeover state starts at bit 22."""
    shapes = _spy_decode_lanes(monkeypatch)
    data = _mkdata(24000, 10, seed=29)
    comp = _encode(data, shards=16, prime=True).compressed
    from qvz_tpu.format import container_v2
    assert container_v2.parse(comp, blocks_len=None).priming
    host = dec_mod.decode(comp)
    dev = dec_mod.decode(comp, device=True)
    assert np.array_equal(dev, host)
    assert shapes


def test_device_decode_130_lanes():
    data = _mkdata(4160, 6, seed=31)
    comp = _encode(data, shards=130, prime=False).compressed
    host = dec_mod.decode(comp)
    dev = dec_mod.decode(comp, device=True)
    assert np.array_equal(dev, host)


def test_cluster_prologue_matches_full_decode():
    """The prologue's cluster ids must equal the ones the full host
    decoder recovers, and its exported coder state must be internally
    consistent (t within [l, u])."""
    from qvz_tpu.format import container_v2
    from qvz_tpu.native import runtime as rt

    data = _mkdata(3000, 8, seed=21)
    comp = _encode(data, shards=2, n_clusters=3, prime=False).compressed
    head = container_v2.parse(comp, blocks_len=None)
    hdr = container_v2.header_size()
    tables = rt.tables_from_blocks(comp[hdr:], head.cluster_count,
                                   head.columns)
    head = container_v2.parse(comp, blocks_len=tables.consumed)
    s = head.shards[0]
    pay = comp[s.payload_off:s.payload_off + s.payload_len]
    well = np.frombuffer(s.well_state, dtype="<u4")
    _, cl_full = rt.decode_colmajor(tables, pay, s.lines, well,
                                    cluster_out=True)
    cl, l0, u0, t0, bits = rt.decode_cluster_prologue(tables, pay,
                                                      s.lines)
    assert np.array_equal(cl, cl_full)
    assert l0 <= t0 <= u0
    assert 22 <= bits <= len(pay) * 8 + 64


def _synth_skewed(n, cols, seed, kind):
    """Pathological data shapes (mirrors test_reference_live's fuzz):
    constant data makes card-1 no-op models dominate, bimodal data
    makes dither choices split hard, saturated/uniform stress the
    alphabet edges."""
    rng = np.random.default_rng(seed)
    if kind == "constant":
        q = np.full((n, cols), 38, dtype=np.uint8)
        q[n // 3] = 2
    elif kind == "bimodal":
        lo = rng.integers(0, 6, size=(n, cols))
        hi = rng.integers(60, 72, size=(n, cols))
        pick = rng.random((n, 1)) < 0.5
        q = np.where(pick, lo, hi).astype(np.uint8)
    elif kind == "saturated":
        q = np.clip(rng.integers(66, 80, size=(n, cols)), 0,
                    71).astype(np.uint8)
    else:
        q = rng.integers(0, 72, size=(n, cols)).astype(np.uint8)
    return q


@pytest.mark.parametrize("kind,cfg", [
    ("constant", dict(shards=3, n_clusters=1)),
    ("bimodal", dict(shards=4, n_clusters=2)),
    ("saturated", dict(shards=3, n_clusters=1, ratio=0.9)),
    ("uniform", dict(shards=4, n_clusters=3, ratio=0.3)),
])
def test_device_decode_pathological_shapes(kind, cfg):
    """The device decode scan must reproduce the host decoder on
    pathological data shapes."""
    data = _synth_skewed(2400, 12, 47, kind)
    comp = _encode(data, prime=False, **cfg).compressed
    host = dec_mod.decode(comp)
    dev = dec_mod.decode(comp, device=True)
    assert np.array_equal(dev, host)


def _rebuild(comp, mutate_payloads):
    """Re-assemble a QVZ2 container with mutated payloads (checksums
    recomputed, so integrity checks pass — the corruption is the
    payload/claimed-geometry mismatch itself)."""
    from qvz_tpu.format import container_v2
    from qvz_tpu.native import runtime as rt

    head = container_v2.parse(comp, blocks_len=None)
    hdr = container_v2.header_size()
    tables = rt.tables_from_blocks(comp[hdr:], head.cluster_count,
                                   head.columns)
    head = container_v2.parse(comp, blocks_len=tables.consumed)
    pays = [bytes(comp[s.payload_off:s.payload_off + s.payload_len])
            for s in head.shards]
    pays = mutate_payloads(pays)
    return container_v2.build(
        bytes(head.blocks), head.cluster_count, head.columns,
        head.lines, [s.lines for s in head.shards],
        [bytes(s.well_state) for s in head.shards], pays,
        order=head.order, priming=head.priming)


def test_device_decode_truncated_payload_raises():
    """A payload truncated to a quarter (with a CONSISTENT directory
    and checksum) makes the host decoder raise ValueError via the
    BitReader overrun fail-fast; the device path must converge on the
    same error instead of silently returning zero-fill garbage
    (round-3 review finding)."""

    def truncate_last(pays):
        return pays[:-1] + [pays[-1][: len(pays[-1]) // 4]]

    data = _mkdata(4000, 20, seed=37)
    comp = _rebuild(_encode(data, shards=3, prime=False).compressed,
                    truncate_last)
    with pytest.raises(ValueError):
        dec_mod.decode(comp)
    with pytest.raises(ValueError):
        dec_mod.decode(comp, device=True)


def test_corrupt_warmup_shard_raises_not_hangs():
    """A corrupt warmup payload in a primed container must surface as
    ValueError on both decode paths — the warmup thread used to leave
    its workers blocked forever (host path) or die into a bare
    KeyError (device path)."""
    data = _mkdata(24000, 10, seed=41)
    comp = bytearray(_encode(data, shards=4, prime=True).compressed)
    from qvz_tpu.format import container_v2
    from qvz_tpu.native import runtime as rt

    head = container_v2.parse(bytes(comp), blocks_len=None)
    hdr = container_v2.header_size()
    tables = rt.tables_from_blocks(bytes(comp[hdr:]),
                                   head.cluster_count, head.columns)
    head = container_v2.parse(bytes(comp), blocks_len=tables.consumed)
    assert head.priming
    comp[head.shards[0].payload_off] ^= 0xFF
    comp = bytes(comp)
    with pytest.raises(ValueError):
        dec_mod.decode(comp)
    with pytest.raises(ValueError):
        dec_mod.decode(comp, device=True)


def test_device_decode_one_wave(monkeypatch):
    """140 lanes decode in ONE wave by default (waves are sized by
    symbols, not lanes)."""
    shapes = _spy_decode_lanes(monkeypatch)
    data = _mkdata(4480, 4, seed=43)  # 140 shards x 32 lines
    comp = _encode(data, shards=140, prime=False).compressed
    host = dec_mod.decode(comp)
    dev = dec_mod.decode(comp, device=True)
    assert np.array_equal(dev, host)
    assert [s[1] for s in shapes] == [140], shapes


def test_device_decode_wave_override(monkeypatch):
    """QVZ_TPU_DEC_WAVE caps the lanes per wave; each wave pads its
    payload words to the same bucket, and the output still matches
    the host decoder."""
    shapes = _spy_decode_lanes(monkeypatch)
    monkeypatch.setenv("QVZ_TPU_DEC_WAVE", "3")
    data = _mkdata(3000, 10, seed=53)
    comp = _encode(data, shards=8, n_clusters=2, prime=False).compressed
    host = dec_mod.decode(comp)
    assert np.array_equal(dec_mod.decode(comp, device=True), host)
    assert [s[1] for s in shapes] == [3, 3, 1, 1], shapes
