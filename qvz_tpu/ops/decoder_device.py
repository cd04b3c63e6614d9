"""Lane-parallel adaptive arithmetic DECODER on the accelerator.

The encode-side twin lives in ops/coder_device.py; this module closes
the loop so the QVZ2 production path can run BOTH coding directions on
the chip (reference semantics: src/arith.c:118-205 decoder steps +
src/qv_stream.c:9-25 adaptive updates, as restructured by the host
decoder qvz_rt.cpp Decoder/qvz_decode_colmajor).

Why decode parallelizes at all: in COLUMN-MAJOR symbol order, step t's
model depends only on
  (a) the symbol decoded L steps earlier (same line, previous column)
      — available from the scan's own carry, and
  (b) the line's cluster id and the WELL dither draw — both known
      before the scan starts (cluster ids come from a tiny host
      prologue over model 0, rt.decode_cluster_prologue; draws are
      interval-independent).
Steps within a column are different lines, so W shard streams advance
in lockstep vector lanes exactly like the encoder.

Design: ONE fused lax.scan, pure XLA u32/f32 (no 64-bit integer math —
see coder_device's exactness notes). Per step and lane:

1. model resolution — ctx/pair/dither lookups are small 1-D gathers
   (ptab/qrtab/slot tables built host-side in DecodePlan);
2. adaptive-model replay — the carry holds the per-lane occurrence
   table counts (W, S) over the column's dense slot axis (reset at
   each column boundary); effective counts are init + 8*occurrences,
   with model totals recovered by an S-axis cumsum;
3. symbol search — the host scans for the first cumulative count with
   cum*range >= (tl+1)*n (qvz_rt.cpp:473-476, itself the reference's
   tag-gap search with the divide eliminated). That comparison is a
   42-bit product test, which splits EXACTLY into u32 halves
   (_mul64_20x22), so the searched symbol is
   x = #{slots j of the model: cum_j*range < (tl+1)*n} — one masked
   popcount over S, zero divisions;
4. interval update — two _exact_div floor divisions (f32 estimate +
   u32 remainder fixup, proven exact over the operand envelope) and
   the encoder's batched E1*/E3* closed-form renormalization, except
   the tag CONSUMES stream bits instead of emitting them;
5. bit feed — a per-lane 64-bit (hi, lo) reservoir over the shard
   payload uploaded as big-endian u32 words; each renorm batch draws
   k <= 21 bits after at most one conditional word refill, and reads
   past the payload end return zero words (the host BitReader's
   zero-fill semantics, qvz_rt.cpp:195-210).

Exactness escape hatches mirror the encoder: a lane whose LIVE column
model would rescale (total past r = 2^19, qv_stream.c:15-24) or whose
tag leaves [l, u] sets a flag and is re-decoded on host — the output
is byte-identical to the host decoder unconditionally. Card-1 models
are exact no-ops for the interval (cum_lo = 0, cum_hi = n) and are
excluded from the rescale check, as on the encode side.

The final symbol of a shard runs as a normal step rather than the
reference's decoder_last_step (arith.c:190-205): both compute the same
boundary search, the extra renormalization only touches state that is
discarded, and the bits it consumes come from the zero-fill tail.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from qvz_tpu.ops.coder_device import (ARITH_M, ARITH_R, FULL, MSB_BIT,
                                      MSB_CLEAR, MSB_SHIFT, SMSB_SHIFT,
                                      STEP, _bucket, _exact_div, _shl32,
                                      _shr32, _put64, _shl64_small)

_U32 = jnp.uint32
_I32 = jnp.int32


# --------------------------------------------------------------------------
# Host-side plan: decode-direction tables over the LanePlan slot layout.


class DecodePlan:
    """Per-(tables, init bank) lookup tables for the device decoder.

    Reuses coder_device.LanePlan's per-column slot layout (slot_base /
    cards / init_counts_cols / mkey / qskey) and adds the decode-side
    resolution tables:
      ptab   (cols, n_cl*72) i32 — pair index for (cluster, prev_qv),
             -1 where the context is unreachable (ctxmap hole);
      qrtab  (n_pairs,) i32     — dither thresholds;
      symtab (cols, S) i32      — decoded symbol value per slot.
    """

    def __init__(self, plan, tables):
        cols, S = plan.columns, plan.S
        n_cl = plan.n_clusters
        moff = np.asarray(tables.model_off, dtype=np.int64)
        msyms = np.asarray(tables.model_syms, dtype=np.uint8)

        symtab = np.zeros((cols, S), dtype=np.int32)
        valid = plan.mkey >= 0
        symtab[valid] = msyms[moff[plan.mkey[valid]]
                              + plan.qskey[valid]].astype(np.int32)

        pair_base = np.asarray(tables.pair_base,
                               dtype=np.int64).reshape(n_cl, cols)
        ctxmap = np.asarray(tables.ctxmap,
                            dtype=np.int64).reshape(n_cl, cols, 72)
        ptab = np.where(ctxmap >= 0, pair_base[:, :, None] + ctxmap, -1)
        self.ptab = np.ascontiguousarray(
            np.transpose(ptab, (1, 0, 2)).reshape(cols, n_cl * 72)
        ).astype(np.int32)
        self.qrtab = np.asarray(tables.qratio).astype(np.int32)
        self.symtab = symtab
        self.plan = plan
        self.columns = cols
        self.S = S
        self.n_clusters = n_cl


# --------------------------------------------------------------------------
# Exact 42-bit product comparison in u32 halves.


def _mul64_20x22(a, b):
    """(hi, lo) u32 pair = a*b for a < 2^20, b <= 2^22 (both u32).

    b splits as bh*2^11 + bl; each partial product stays below 2^31,
    so every intermediate is exact in u32 mod-2^32 arithmetic."""
    bh = b >> _U32(11)
    bl = b & _U32(0x7FF)
    p1 = a * bh
    p2 = a * bl
    lo1 = p1 << _U32(11)
    lo = lo1 + p2
    carry = (lo < lo1).astype(_U32)
    hi = (p1 >> _U32(21)) + carry
    return hi, lo


def _lt64(h1, l1, h2, l2):
    return (h1 < h2) | ((h1 == h2) & (l1 < l2))


# --------------------------------------------------------------------------
# Per-lane bit reservoir (MSB-first over big-endian payload words).


def _e1_lu(l, u):
    """E1* batch on (l, u): returns (k1, l', u') — the decoder consumes
    k1 stream bits into the tag (qvz_rt.cpp Decoder::step E1 block)."""
    diff = l ^ u
    e1 = (diff >> _U32(MSB_SHIFT)) == 0
    k1 = jnp.where(e1, jax.lax.clz(diff << _U32(32 - ARITH_M)),
                   _U32(0)).astype(_I32)
    one = jnp.ones_like(l)
    l = _shl32(l, k1) & FULL
    u = (_shl32(u, k1) | (_shl32(one, k1) - 1)) & FULL
    return k1, l, u


def _e3_lu(l, u):
    """E3* batch on (l, u): returns (k3, msb_or, l', u'); the tag then
    takes k3 bits and a single final MSB flip (^ msb_or)."""
    e3 = ((l >> _U32(SMSB_SHIFT)) == 1) & ((u >> _U32(SMSB_SHIFT)) == 2)
    lx = l << _U32(32 - SMSB_SHIFT)
    ux = u << _U32(32 - SMSB_SHIFT)
    lrun = jax.lax.clz(~lx | _U32(1)).astype(_I32)
    zrun = jnp.where(ux != 0, jax.lax.clz(ux).astype(_I32), 32)
    k3 = jnp.where(e3, 1 + jnp.minimum(lrun, zrun), 0)
    one = jnp.ones_like(l)
    ones_k3 = _shl32(one, k3) - 1
    lmask = jnp.where(e3, _U32(MSB_CLEAR), FULL)
    msb_or = jnp.where(e3, _U32(MSB_BIT), _U32(0))
    l = _shl32(l, k3) & lmask
    u = ((_shl32(u, k3) & lmask) | msb_or) | ones_k3
    return k3, msb_or, l, u


def _refill(rhi, rlo, nb, wpos, payw):
    """Ensure >= 21 buffered bits by appending one payload word where
    short. payw is zero-padded past each lane's payload, so overshoot
    reads reproduce the host BitReader's zero fill."""
    need = nb < 21
    P = payw.shape[1]
    idx = jnp.minimum(wpos, P - 1).astype(_I32)
    w = jnp.take_along_axis(payw, idx[:, None], axis=1)[:, 0]
    pos = jnp.clip(32 - nb, 0, 32)
    ahi, alo = _put64(w, pos)
    rhi = jnp.where(need, rhi | ahi, rhi)
    rlo = jnp.where(need, rlo | alo, rlo)
    nb = jnp.where(need, nb + 32, nb)
    wpos = jnp.where(need, wpos + 1, wpos)
    return rhi, rlo, nb, wpos


def _serve(rhi, rlo, nb, k):
    """Pop the top k (in [0, 21]) bits of the reservoir."""
    v = _shr32(rhi, 32 - k)
    rhi, rlo = _shl64_small(rhi, rlo, k)
    return v, rhi, rlo, nb - k


def _overrun(wpos_words, payloads) -> np.ndarray:
    """Per-lane overrun fail-fast, mirroring the host BitReader's
    next > len + 64 heuristic (qvz_rt.cpp:248-253): a corrupt container
    claiming more symbols than its payload carries reads deep into the
    zero-fill tail without ever tripping the tag-range check — flag it
    so the host re-decode raises the documented ValueError instead of
    the device path silently returning garbage. Valid streams keep
    wpos*4 within ~16 bytes of the payload end (<= 96 buffered bits +
    the final-drain slack), far inside the 64-byte margin."""
    paylens = np.asarray([len(p) for p in payloads], dtype=np.int64)
    return wpos_words * 4 > paylens + 64


# --------------------------------------------------------------------------
# The decode scan.


def _dec_step(carry, xs, *, ptab, qrtab, sbtab, cardtab, icc, symtab,
              payw, cl, W, S):
    l, u, t, rhi, rlo, nb, wpos, counts, prevqv, bad, of = carry
    col, i, reset, draw = xs

    counts = counts * jnp.logical_not(reset).astype(_I32)

    # --- model resolution (qvz_decode_colmajor's per-column pass) ---
    cli = jax.lax.dynamic_slice(cl, (0, i), (W, 1))[:, 0]
    prev = jax.lax.dynamic_slice(prevqv, (0, i), (W, 1))[:, 0]
    prow = jax.lax.dynamic_slice_in_dim(ptab, col, 1, axis=0)[0]
    p = prow[cli * 72 + prev]
    bad = bad | (p < 0)
    p = jnp.maximum(p, 0)
    choice = (draw >= qrtab[p]).astype(_I32)
    mid = 1 + 2 * p + choice
    sb = sbtab[mid]
    card = cardtab[mid]
    sbc = sb + card
    live = card > 1

    # --- replay: effective counts and model-relative cumulatives ---
    icc_c = jax.lax.dynamic_slice_in_dim(icc, col, 1, axis=0)  # (1, S)
    eff = icc_c + STEP * counts                                # (W, S)
    cum = jnp.cumsum(eff, axis=1)
    iota = jnp.arange(S, dtype=_I32)[None, :]
    sb_c = sb[:, None]
    in_m = (iota >= sb_c) & (iota < sbc[:, None])
    base = jnp.sum(jnp.where(iota == sb_c, cum - eff, 0), axis=1)
    n = jnp.sum(jnp.where(iota == (sbc - 1)[:, None], cum, 0),
                axis=1) - base
    rel = jnp.where(in_m, cum - base[:, None], 0).astype(_U32)

    # --- symbol search (zero divides) ---
    bad = bad | (t < l) | (t > u)
    rng = u - l + 1
    tl = t - l
    lh, ll = _mul64_20x22(rel, rng[:, None])
    th, tlo = _mul64_20x22(n.astype(_U32), tl + 1)
    x = jnp.sum((in_m & _lt64(lh, ll, th[:, None], tlo[:, None]))
                .astype(_I32), axis=1)

    eq = iota == (sb + x)[:, None]
    cum_hi = jnp.sum(jnp.where(eq, rel, _U32(0)), axis=1)
    cnt_x = jnp.sum(jnp.where(eq, eff, 0), axis=1).astype(_U32)
    cum_lo = cum_hi - cnt_x
    nu = n.astype(_U32)
    qhi = jnp.where(cum_hi == nu, rng, _exact_div(rng, cum_hi, nu))
    qlo = jnp.where(cum_lo == 0, _U32(0), _exact_div(rng, cum_lo, nu))
    u = l + qhi - 1
    l = l + qlo

    of = of | (live & (n + STEP > int(ARITH_R)))

    # --- E1* batch: consume the shared leading bits ---
    k1, l, u = _e1_lu(l, u)
    rhi, rlo, nb, wpos = _refill(rhi, rlo, nb, wpos, payw)
    v1, rhi, rlo, nb = _serve(rhi, rlo, nb, k1)
    t = (_shl32(t, k1) | v1) & FULL

    # --- E3* batch: straddle runs, single final MSB flip on the tag ---
    k3, msb_or, l, u = _e3_lu(l, u)
    rhi, rlo, nb, wpos = _refill(rhi, rlo, nb, wpos, payw)
    v3, rhi, rlo, nb = _serve(rhi, rlo, nb, k3)
    t = ((_shl32(t, k3) | v3) & FULL) ^ msb_or

    # --- bookkeeping: adaptive update + previous-column buffer ---
    counts = counts + jnp.where(live[:, None], eq.astype(_I32), 0)
    srow = jax.lax.dynamic_slice_in_dim(symtab, col, 1, axis=0)
    qv = jnp.sum(jnp.where(eq, srow, 0), axis=1)
    prevqv = jax.lax.dynamic_update_slice(prevqv, qv[:, None], (0, i))
    return (l, u, t, rhi, rlo, nb, wpos, counts, prevqv, bad, of), \
        qv.astype(jnp.uint8)


@partial(jax.jit, static_argnames=("W", "S", "L", "cols"))
def _decode_scan(ptab, qrtab, sbtab, cardtab, icc, symtab, payw, draws,
                 cl, l0, u0, t0, rhi0, rlo0, nb0, wpos0, W, S, L, cols):
    csteps = cols * L
    col_s = jnp.arange(csteps, dtype=_I32) // L
    i_s = jnp.arange(csteps, dtype=_I32) % L
    reset_s = i_s == 0

    # loop-invariant tables close over the step body (XLA keeps them
    # resident; only the per-step (col, i, reset, draw, cl) quintuple
    # is sliced from xs)
    step = partial(_dec_step, ptab=ptab, qrtab=qrtab, sbtab=sbtab,
                   cardtab=cardtab, icc=icc, symtab=symtab, payw=payw,
                   cl=cl.astype(_I32), W=W, S=S)

    init = (l0, u0, t0, rhi0, rlo0, nb0, wpos0,
            jnp.zeros((W, S), _I32), jnp.zeros((W, L), _I32),
            jnp.zeros(W, bool), jnp.zeros(W, bool))
    carry, qv_s = jax.lax.scan(
        step, init, (col_s, i_s, reset_s, draws.astype(_I32)))
    return carry, qv_s


# --------------------------------------------------------------------------
# Driver.


def decode_lanes(dplan: DecodePlan, payloads, draws, cl, states,
                 timings: dict | None = None):
    """Decode W equal-length column-major shard payloads in vector
    lanes.

    payloads: list of W payload byte strings; draws: (cols, W, L) u8
    dither draws (each shard's WELL stream, transposed); cl: (W, L) u8
    cluster ids (zeros when n_clusters == 1); states: per-lane
    (l, u, t, bitpos) start tuples — (0, FULL, first-22-bits, 22) when
    there is no cluster prologue, else rt.decode_cluster_prologue's
    output.

    Returns (qv (W, L, cols) uint8 symbol values 0..71, flags (W,)
    bool — flagged lanes must be re-decoded on host)."""
    import time

    t_seg = time.perf_counter()
    plan = dplan.plan
    cols, S = dplan.columns, dplan.S
    W = len(payloads)
    L = cl.shape[1]

    # payload words, big-endian, >= 2 zero words of BitReader zero-fill;
    # the word count is bucketed so waves share one compiled scan
    max_bytes = max(len(p) for p in payloads)
    P = _bucket((max_bytes + 3) // 4 + 2)
    payw = np.zeros((W, P), dtype=">u4")
    for w, p in enumerate(payloads):
        buf = np.frombuffer(p, dtype=np.uint8)
        full, remn = divmod(len(buf), 4)
        payw[w, :full] = buf[: full * 4].view(">u4")
        if remn:
            tail = np.zeros(4, dtype=np.uint8)
            tail[:remn] = buf[full * 4:]
            payw[w, full] = tail.view(">u4")[0]
    payw = payw.astype(np.uint32)

    st = np.asarray([list(s) for s in states], dtype=np.uint64)

    l0 = st[:, 0].astype(np.uint32)
    u0 = st[:, 1].astype(np.uint32)
    t0 = st[:, 2].astype(np.uint32)
    bitpos = st[:, 3].astype(np.int64)
    wpos0 = (bitpos // 32).astype(np.int32)
    off = (bitpos % 32).astype(np.uint32)
    w0 = payw[np.arange(W), np.minimum(wpos0, P - 1)]
    rhi0 = np.where(off < 32, w0 << off, 0).astype(np.uint32)
    rlo0 = np.zeros(W, dtype=np.uint32)
    nb0 = (32 - off).astype(np.int32)
    wpos0 = (wpos0 + 1).astype(np.int32)

    # draws arrive (cols, W, L); flatten to the (csteps, W) stream
    draws_s = np.ascontiguousarray(
        np.swapaxes(draws, 1, 2).reshape(cols * L, W))

    if timings is not None:
        timings["prep"] = time.perf_counter() - t_seg
        t_seg = time.perf_counter()

    carry, qv_s = _decode_scan(
        jnp.asarray(dplan.ptab), jnp.asarray(dplan.qrtab),
        jnp.asarray(plan.slot_base.astype(np.int32)),
        jnp.asarray(plan.cards.astype(np.int32)),
        jnp.asarray(plan.init_counts_cols.astype(np.int32)),
        jnp.asarray(dplan.symtab), jnp.asarray(payw),
        jnp.asarray(draws_s), jnp.asarray(cl),
        jnp.asarray(l0), jnp.asarray(u0), jnp.asarray(t0),
        jnp.asarray(rhi0), jnp.asarray(rlo0), jnp.asarray(nb0),
        jnp.asarray(wpos0), W, S, L, cols)
    bad, of = carry[9], carry[10]
    flags = np.asarray(bad | of)
    flags = flags | _overrun(np.asarray(carry[6]).astype(np.int64),
                             payloads)
    # (csteps, W) -> (cols, L, W) -> (W, L, cols)
    qv = np.ascontiguousarray(
        np.transpose(np.asarray(qv_s).reshape(cols, L, W), (2, 1, 0)))
    if timings is not None:
        timings["scan_fetch"] = time.perf_counter() - t_seg
    return qv, flags
