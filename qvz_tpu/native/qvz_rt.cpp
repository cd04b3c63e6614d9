// qvz_rt: native host runtime for the qvz_tpu framework.
//
// Implements the pieces of the QVZ pipeline whose bit-level semantics are
// baked into the bitstream and which are inherently sequential or tiny:
//   * WELL-1024a dither-draw generation            (ref: src/well.c)
//   * Lloyd-Max codebook design, exact doubles     (ref: src/quantizer.c,
//     src/codebook.c:230-468)
//   * codebook serialization / table construction  (ref: src/codebook.c:
//     474-669)
//   * context-adaptive arithmetic coding           (ref: src/arith.c,
//     src/qv_stream.c, src/os_stream.c)
//
// The heavy O(reads x columns) modeling passes (clustering, histograms,
// quantization) run on the accelerator via JAX; this library consumes
// their outputs.
//
// Bit-exactness notes: compile WITHOUT -march=native and WITH
// -ffp-contract=off so no FMA contraction changes double rounding; libm
// log2() matches the reference binary's. All accumulation orders follow
// the reference (see the per-function comments).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <cmath>
#include <cfloat>
#include <functional>
#include <mutex>
#include <thread>

#if defined(__AVX2__)
#include <immintrin.h>
#endif
#include <unordered_map>
#include <vector>
#include <string>

#include "qvz_rt.h"

namespace {

constexpr int A = 72;                 // alphabet size

// Work-stealing-free parallel for: deterministic results require only
// that fn(i) be pure w.r.t. disjoint outputs (each index owns its slot).
void parallel_for(size_t n, bool threaded,
                  const std::function<void(size_t)>& fn) {
  unsigned hw = std::thread::hardware_concurrency();
  size_t nt = std::min<size_t>(hw ? hw : 1, n);
  if (!threaded || nt <= 1 || n < 4) {
    for (size_t i = 0; i < n; ++i) fn(i);
    return;
  }
  std::atomic<size_t> next{0};
  std::vector<std::thread> ts;
  for (size_t t = 0; t < nt; ++t) {
    ts.emplace_back([&] {
      for (size_t i; (i = next.fetch_add(1)) < n;) fn(i);
    });
  }
  for (auto& t : ts) t.join();
}
constexpr uint32_t kArithM = 22;
constexpr uint32_t kArithR = 1u << (kArithM - 3);
constexpr uint32_t kMsbShift = kArithM - 1;
constexpr uint32_t kSmsbShift = kArithM - 2;
constexpr uint32_t kMsbClear = (1u << kMsbShift) - 1;
constexpr uint32_t kMsbBit = 1u << kMsbShift;
constexpr uint32_t kFull = (1u << kArithM) - 1;
constexpr uint32_t kStep = 8;
constexpr int kMaxIter = 100;         // Lloyd-Max iteration cap

// ---------------------------------------------------------------- WELL

struct Well {
  uint32_t s[32];
  uint32_t n = 0;
  uint32_t pool = 0;
  uint32_t pool_bits = 0;

  explicit Well(const uint32_t* state) {
    std::memcpy(s, state, 32 * sizeof(uint32_t));
  }

  inline uint32_t word() {
    uint32_t z0 = s[(n + 31) & 31];
    uint32_t vm1 = s[(n + 3) & 31];
    uint32_t vm2 = s[(n + 24) & 31];
    uint32_t vm3 = s[(n + 10) & 31];
    uint32_t z1 = s[n] ^ (vm1 ^ (vm1 >> 8));
    uint32_t z2 = (vm2 ^ (vm2 << 19)) ^ (vm3 ^ (vm3 << 14));
    s[n] = z1 ^ z2;
    n = (n + 31) & 31;
    s[n] = (z0 ^ (z0 << 11)) ^ (z1 ^ (z1 << 7)) ^ (z2 ^ (z2 << 13));
    return s[n];
  }

  // 7-bit draw from a shared pool; refill checked BEFORE the draw so the
  // last 4 bits of every pool word are discarded (well.c:33-46).
  inline uint32_t draw7() {
    if (pool_bits < 7) {
      pool = word();
      pool_bits = 32;
    }
    uint32_t r = pool & 0x7F;
    pool >>= 7;
    pool_bits -= 7;
    return r;
  }
};

// ------------------------------------------------------------ bit sink

// MSB-first bit sinks/sources with 64-bit batching. Byte-for-byte
// identical output/consumption to the reference's per-bit os_stream
// (os_stream.c:35-110); only the internal buffering differs.
struct BitWriter {
  uint8_t* out;
  int64_t cap;
  int64_t pos = 0;      // bytes committed to `out`
  uint64_t acc = 0;     // pending bits, newest in the low end
  int nbits = 0;        // pending bit count, < 64 between calls
  bool overflow = false;

  BitWriter(uint8_t* o, int64_t c) : out(o), cap(c) {}

  inline void flush64() {
    if (pos + 8 <= cap) {
      // big-endian store: first-written bit ends up in out[pos] bit 7
      uint64_t be = __builtin_bswap64(acc);
      std::memcpy(out + pos, &be, 8);
    } else {
      for (int i = 0; i < 8; ++i) {
        uint8_t b = static_cast<uint8_t>(acc >> (56 - 8 * i));
        if (pos + i < cap) out[pos + i] = b;
        else overflow = true;
      }
    }
    pos += 8;
    acc = 0;
    nbits = 0;
  }

  inline void put(uint32_t bit) {
    acc = (acc << 1) | (bit & 1u);
    if (++nbits == 64) flush64();
  }

  // Append len bits of v (MSB-first), len <= 32.
  inline void putk(uint32_t v, int len) {
    int space = 64 - nbits;
    if (len <= space) {
      acc = (acc << len) | v;
      nbits += len;
      if (nbits == 64) flush64();
    } else {
      acc = (acc << space) | (v >> (len - space));
      nbits = 64;
      flush64();
      int rest = len - space;
      acc = v & ((1u << rest) - 1u);
      nbits = rest;
    }
  }

  inline void put_bits(uint32_t dw, int len) {
    for (int b = len - 1; b >= 0; --b) put((dw >> b) & 1u);
  }

  // stream_finish_byte: flushes unconditionally, so a stream ending on a
  // byte boundary gains one extra zero byte (os_stream.c:105-110).
  void finish_byte() {
    int pad = 7 - (nbits & 7);
    acc <<= pad + 1;  // the reference always emits one more (padded) byte
    nbits += pad + 1;
    while (nbits >= 8) {
      uint8_t b = static_cast<uint8_t>(acc >> (nbits - 8));
      if (pos < cap) out[pos] = b;
      else overflow = true;
      ++pos;
      nbits -= 8;
    }
    acc = 0;
  }
};

struct BitReader {
  const uint8_t* data;
  uint64_t len;
  uint64_t next = 0;    // next byte to refill from
  uint64_t acc = 0;     // upcoming bits at the high end
  int navail = 0;

  BitReader(const uint8_t* d, uint64_t l) : data(d), len(l) {}

  inline void refill() {
    // zero past EOF, matching the reference's calloc'd stream buffer
    if (next + 8 <= len) {
      uint64_t be;
      std::memcpy(&be, data + next, 8);
      acc = __builtin_bswap64(be);
    } else {
      acc = 0;
      for (int i = 0; i < 8; ++i) {
        uint8_t b = (next + i < len) ? data[next + i] : 0;
        acc = (acc << 8) | b;
      }
    }
    next += 8;
    navail = 64;
  }

  inline uint32_t get() {
    if (navail == 0) refill();
    uint32_t bit = static_cast<uint32_t>(acc >> 63);
    acc <<= 1;
    --navail;
    return bit;
  }

  // Next k bits MSB-first, 0 <= k <= 32 (at most one refill: k <= 56).
  inline uint32_t getk(int k) {
    uint32_t v;
    if (navail >= k) {
      // double shift keeps k == 0 well-defined (acc >> 64 is UB)
      v = static_cast<uint32_t>((acc >> 1) >> (63 - k));
      acc <<= k;
      navail -= k;
    } else {
      int have = navail;
      v = have ? static_cast<uint32_t>(acc >> (64 - have)) : 0u;
      refill();
      int need = k - have;
      v = (v << need) | static_cast<uint32_t>(acc >> (64 - need));
      acc <<= need;
      navail -= need;
    }
    return v;
  }

  uint32_t get_bits(int n) {
    uint32_t v = 0;
    for (int b = n - 1; b >= 0; --b) v |= get() << b;
    return v;
  }

  // A VALID stream never consumes more than a few refill words past
  // its end (final-byte drain + 64-bit refill slack); far overshoot
  // means a corrupt container claiming more symbols than the payload
  // carries — callers use this to fail fast instead of decoding
  // garbage for the full claimed line count.
  inline bool overrun() const { return next > len + 64; }
};

// ----------------------------------------------------- adaptive models

// Flat model bank: counts for model m live at counts[off[m] .. off[m]+card).
//
// Besides the adaptive counts (qv_stream.c:9-61 semantics), the bank
// caches a per-model "round-up" reciprocal magic[m] = ceil(2^64 /
// total[m]). The coder's interval bounds floor(range*cum/total) are
// then a 64x64 mulhi instead of a 64-bit divide: with e = magic*n -
// 2^64 in (0, n], floor(a*magic / 2^64) == floor(a/n) exactly whenever
// e*a < 2^64; here e <= n < 2^20 and a = range*cum < 2^42, so e*a <
// 2^62 — exact for every reachable operand. The one real divide
// (recomputing the magic) moves into update(), OFF the coder's
// symbol-to-symbol critical path, where out-of-order execution hides
// it. (A shared magic table keyed by n was tried in round 1 and was
// SLOWER — the table lookup missed cache; per-model storage rides the
// same cache lines as the model metadata.)
struct ModelBank {
  // Per-model header: offset into counts, cardinality, current total,
  // and the reciprocal magic — one 32-byte record so a single cache
  // line serves the whole per-symbol model lookup.
  struct MInfo {
    uint64_t off;
    uint32_t card;
    uint32_t total;
    uint64_t magic;  // ceil(2^64/total); 0 iff total == 1
    uint64_t pad;
  };
  std::vector<uint32_t> counts;
  std::vector<MInfo> info;

  // ceil(2^64/n) for n >= 2; 0 for n <= 1 (never consulted: the coder
  // takes the cum==0/cum==n edge paths whenever total is 1).
  // Negative result (kept for the record): computing this via a
  // pipelined double divide + exact integer fix-up (valid for
  // n >= 2048, verified exhaustively) measured ~10% SLOWER end-to-end
  // on the bench host than the integer divider — the int<->fp
  // transfers and 128-bit fix-up multiplies cost more than the
  // off-critical-path divide they replaced.
  static inline uint64_t recip(uint32_t n) {
    return n > 1 ? ~0ull / n + 1 : 0;
  }

  void init(const uint32_t* cards, uint32_t n_models) {
    info.resize(n_models);
    uint64_t o = 0;
    for (uint32_t m = 0; m < n_models; ++m) {
      info[m].off = o;
      info[m].card = cards[m];
      o += cards[m];
      info[m].total = cards[m];  // counts start at 1 each
      info[m].magic = recip(cards[m]);
    }
    counts.assign(o, 1u);
  }

  // Pull the next model's header + counts toward L1 while the current
  // symbol's interval update is still in flight.
  inline void prefetch(uint32_t m) const {
    const MInfo& mi = info[m];
    __builtin_prefetch(&mi);
    __builtin_prefetch(counts.data() + mi.off);
  }

  // Snapshot blob = counts then per-model totals (u32 each); magic is
  // derived on load. Used by QVZ2 shard priming: encoder and decoder
  // both derive the SAME warmup state by processing shard 0, so no
  // prior table is ever serialized into the container.
  uint64_t blob_words() const { return counts.size() + info.size(); }

  void dump(uint32_t* blob) const {
    std::memcpy(blob, counts.data(), counts.size() * sizeof(uint32_t));
    uint32_t* t = blob + counts.size();
    for (size_t m = 0; m < info.size(); ++m) t[m] = info[m].total;
  }

  void load(const uint32_t* blob) {
    std::memcpy(counts.data(), blob, counts.size() * sizeof(uint32_t));
    const uint32_t* t = blob + counts.size();
    for (size_t m = 0; m < info.size(); ++m) {
      info[m].total = t[m];
      info[m].magic = recip(t[m]);
    }
  }

  inline void update(uint32_t m, uint32_t x) {
    MInfo& mi = info[m];
    uint32_t* c = counts.data() + mi.off;
    c[x] += kStep;
    uint32_t n = mi.total + kStep;
    if (n > kArithR) {
      n = 0;
      uint32_t k = mi.card;
      for (uint32_t i = 0; i < k; ++i) {
        if (c[i]) {
          c[i] = (c[i] >> 1) + 1;
          n += c[i];
        }
      }
    }
    mi.total = n;
    mi.magic = recip(n);
  }
};

// floor(a * magic / 2^64): exact floor(a/n) under the bank's invariant.
static inline uint32_t mulh_div(uint64_t a, uint64_t magic) {
  return static_cast<uint32_t>(
      (static_cast<unsigned __int128>(a) * magic) >> 64);
}


// -------------------------------------------------- arithmetic coding

struct Encoder {
  uint32_t l = 0, u = kFull;
  int32_t scale3 = 0;
  BitWriter* bw;

  explicit Encoder(BitWriter* w) : bw(w) {}

  inline void step(const ModelBank& bank, uint32_t m, uint32_t x) {
    const ModelBank::MInfo& mi = bank.info[m];
    const uint32_t* c = bank.counts.data() + mi.off;
    uint32_t n = mi.total;
    uint64_t M = mi.magic;
    uint64_t range = static_cast<uint64_t>(u) - l + 1;
    uint32_t cum_lo = 0;
    for (uint32_t i = 0; i < x; ++i) cum_lo += c[i];
    uint32_t cum_hi = cum_lo + c[x];
    // Skewed adaptive models hit the edges constantly; (range*n)/n ==
    // range and (range*0)/n == 0 exactly, so skip even the mulhi. The
    // general case is an exact reciprocal multiply (see ModelBank).
    u = l + (cum_hi == n ? static_cast<uint32_t>(range)
                         : mulh_div(range * cum_hi, M)) - 1;
    l = l + (cum_lo == 0 ? 0u : mulh_div(range * cum_lo, M));

    // Batched renormalization. The bit-at-a-time E1/E2/E3 loop
    // (arith.c:52-96) telescopes: k consecutive E1/E2 steps emit the
    // top k shared bits of l (scale3 complements after the first) and
    // apply l<-(l<<k)&F, u<-((u<<k)|(2^k-1))&F; k consecutive E3 steps
    // drop the second bit k times: scale3+=k, l<-(l<<k)&(F>>1),
    // u<-((u<<k)&(F>>1))|MSB|(2^k-1). After an E3 run the MSBs differ
    // and the second bits are out of the straddle, so the sequence is
    // always E1* E3* — two batches, no loop. Bit-exact vs the
    // reference (all goldens + live fuzz).
    uint32_t diff = l ^ u;
    if ((diff >> kMsbShift) == 0) {
      int k1 = __builtin_clz(diff << (32 - kArithM));
      uint32_t top = l >> (kArithM - k1);
      uint32_t first = top >> (k1 - 1);
      bw->put(first);
      if (scale3 > 0) {
        uint32_t comp = first ^ 1u;
        do {
          bw->put(comp);
        } while (--scale3 > 0);
      }
      if (k1 > 1) bw->putk(top & ((1u << (k1 - 1)) - 1u), k1 - 1);
      l = (l << k1) & kFull;
      u = ((u << k1) | ((1u << k1) - 1u)) & kFull;
    }
    if ((l >> kSmsbShift) == 0x01 && (u >> kSmsbShift) == 0x02) {
      uint32_t lx = l << (32 - kSmsbShift);       // l bits below the 01
      uint32_t ux = u << (32 - kSmsbShift);       // u bits below the 10
      int lrun = __builtin_clz(~lx | 1u);         // leading 1s of l
      int zrun = ux ? __builtin_clz(ux) : 32;     // leading 0s of u
      int k3 = 1 + (lrun < zrun ? lrun : zrun);
      scale3 += k3;
      l = (l << k3) & kMsbClear;
      u = (((u << k3) & kMsbClear) | kMsbBit) | ((1u << k3) - 1u);
    }
  }

  int64_t finish() {
    uint32_t msb_l = l >> kMsbShift;
    bw->put(msb_l);
    uint32_t comp = msb_l ^ 1u;
    while (scale3 > 0) {
      bw->put(comp);
      --scale3;
    }
    bw->put_bits(l, kArithM - 1);
    bw->finish_byte();
    return bw->pos;
  }
};

struct Decoder {
  uint32_t l = 0, u = kFull, t = 0;
  BitReader* br;

  explicit Decoder(BitReader* r) : br(r) { t = br->get_bits(kArithM); }

  bool bad = false;  // corrupt-stream flag (tag left [l, u])

  inline uint32_t step(const ModelBank& bank, uint32_t m) {
    if (t < l || t > u) { bad = true; return 0; }
    const ModelBank::MInfo& mi = bank.info[m];
    const uint32_t* c = bank.counts.data() + mi.off;
    uint32_t n = mi.total;
    uint64_t M = mi.magic;
    uint64_t range = static_cast<uint64_t>(u) - l + 1;
    // Direct boundary search replacing the reference's tag-gap divide
    // (arith.c:130-137): symbol x is the first k with t - l <
    // floor(range*cum_{k+1}/n), which is EQUIVALENT to the reference's
    // "first cum > sub" search — cum > floor((tag_gap*n-1)/range) iff
    // cum*range >= tag_gap*n iff floor(cum*range/n) >= tag_gap iff
    // t < l + floor(range*cum/n). The scanned bounds are then reused
    // for the interval update, so the step runs with ZERO divides.
    uint32_t tl = t - l;
    // Scan on cum*range >= T, the reference's "cum > sub"
    // (arith.c:130-137) with the tag-gap divide eliminated. Negative
    // results (both reverted, measured on the bench profile where the
    // mean symbol index is 1.34): a branch-free 16-lane AVX2 search
    // (vector prefix chain + mask extraction cost more than the short
    // scan), and a fixed 4-wide branchless prefix with popcount index
    // selection (4 unconditional multiplies + a store-forwarded select
    // lost ~20% decode throughput vs the predicted short scan). The
    // plain scan with its partially-predictable exit wins.
    uint64_t T = static_cast<uint64_t>(tl + 1) * n;
    uint32_t k = 0;
    uint32_t cum = c[0];
    while (static_cast<uint64_t>(cum) * range < T) cum += c[++k];
    uint32_t x = k;
    uint32_t cum_hi = cum;
    uint32_t cum_lo = cum_hi - c[x];
    uint32_t hi_b = (cum_hi == n ? static_cast<uint32_t>(range)
                                 : mulh_div(range * cum_hi, M));
    uint32_t lo_b = (cum_lo == 0 ? 0u : mulh_div(range * cum_lo, M));
    u = l + hi_b - 1;
    l = l + lo_b;

    // Batched renormalization (see Encoder::step): E1* then E3*.
    // t telescopes to ((t<<k)|streambits)&F for E1 runs, with a single
    // final MSB flip for an E3 run of any length (the intermediate
    // flips cancel as the flipped bit shifts out). Both batches run
    // UNCONDITIONALLY with k=0 as a no-op — whether a symbol emits
    // bits carries ~1 bit of entropy, so the guarding branches were
    // intrinsically unpredictable; straight-line cmov code beats them.
    uint32_t diff = l ^ u;
    int k1 = (diff >> kMsbShift) == 0
                 ? __builtin_clz(diff << (32 - kArithM)) : 0;
    l = (l << k1) & kFull;
    u = ((u << k1) | ((1u << k1) - 1u)) & kFull;
    t = ((t << k1) | br->getk(k1)) & kFull;
    bool e3 = (l >> kSmsbShift) == 0x01 && (u >> kSmsbShift) == 0x02;
    uint32_t lx = l << (32 - kSmsbShift);
    uint32_t ux = u << (32 - kSmsbShift);
    int lrun = __builtin_clz(~lx | 1u);
    int zrun = ux ? __builtin_clz(ux) : 32;
    int k3 = e3 ? 1 + (lrun < zrun ? lrun : zrun) : 0;
    uint32_t flip = e3 ? kMsbBit : 0u;
    uint32_t msb_or = e3 ? kMsbBit : 0u;
    uint32_t lmask = e3 ? kMsbClear : kFull;
    l = (l << k3) & lmask;
    u = (((u << k3) & lmask) | msb_or) | ((1u << k3) - 1u);
    t = (((t << k3) | br->getk(k3)) & kFull) ^ flip;
    return x;
  }

  // Final-symbol drain without renormalization (arith.c:190-205).
  inline uint32_t last(const ModelBank& bank, uint32_t m) const {
    if (t < l || t > u) return 0;
    const ModelBank::MInfo& mi = bank.info[m];
    const uint32_t* c = bank.counts.data() + mi.off;
    uint32_t n = mi.total;
    uint64_t M = mi.magic;
    uint64_t range = static_cast<uint64_t>(u) - l + 1;
    uint32_t tl = t - l;
    uint32_t k = 0;
    uint32_t cum = c[0];
    for (;;) {
      uint32_t b = (cum == n ? static_cast<uint32_t>(range)
                             : mulh_div(range * cum, M));
      if (tl < b) return k;
      cum += c[++k];
    }
  }
};

// ------------------------------------------------- Lloyd-Max design

// A designed quantizer: full 72-entry map plus its output symbol list
// (the raw reconstruction array, duplicates preserved).
struct Quant {
  uint8_t q[A];
  std::vector<uint8_t> out_syms;  // alloc_alphabet copy of reconstruction
  double ratio = 0.0;
};

// Reference-exact Lloyd-Max (quantizer.c:34-132). See spec/quantizer.py
// for the full semantics commentary; loop orders are identical.
// dist_t is the transposed distortion matrix (dist_t[r*A+i] ==
// dist[i*A+r]): the candidate-scan inner loop then reads contiguous
// doubles. The i-accumulation order is unchanged, so every double
// rounds identically to the reference.
static void lloyd_max(const double* pmf, const double* dist,
                      const double* dist_t, int states, Quant* out) {
  int bounds[A + 1];
  int rec[A];
  bounds[0] = 0;
  bounds[states] = A;
  for (int j = 1; j < states; ++j) bounds[j] = (j * A) / states;
  for (int j = 0; j < states; ++j) rec[j] = (bounds[j] + bounds[j + 1] - 1) / 2;

  bool changed = true;
  int iter = 0;
  while (changed && iter < kMaxIter) {
    changed = false;
    ++iter;
    for (int j = 0; j < states; ++j) {
      double min_mse = DBL_MAX;
      int min_r = bounds[j];
      int lo = bounds[j], hi = bounds[j + 1];
      // Four candidate points at once: each accumulator is its own
      // ascending-i chain (bit-identical to the scalar loop) and the
      // independent chains hide FP add latency. Winner comparisons
      // run in ascending r with strict <, exactly like the reference.
      int r = lo;
      for (; r + 3 < hi; r += 4) {
        const double* d0 = dist_t + static_cast<size_t>(r) * A;
        const double* d1 = d0 + A;
        const double* d2 = d1 + A;
        const double* d3 = d2 + A;
        double m0 = 0.0, m1 = 0.0, m2 = 0.0, m3 = 0.0;
        for (int i = lo; i < hi; ++i) {
          double p = pmf[i];
          m0 += p * d0[i];
          m1 += p * d1[i];
          m2 += p * d2[i];
          m3 += p * d3[i];
        }
        double ms[4] = {m0, m1, m2, m3};
        for (int t = 0; t < 4; ++t) {
          if (ms[t] < min_mse) {
            min_r = r + t;
            min_mse = ms[t];
          }
        }
      }
      for (; r < hi; ++r) {
        const double* drow = dist_t + static_cast<size_t>(r) * A;
        double mse = 0.0;
        for (int i = lo; i < hi; ++i) {
          mse += pmf[i] * drow[i];
        }
        if (mse < min_mse) {
          min_r = r;
          min_mse = mse;
        }
      }
      if (min_r != rec[j]) {
        changed = true;
        rec[j] = min_r;
      }
    }
    int r = 0;
    for (int j = 1; j < A - 1 && r < states - 1; ++j) {
      double mse = dist[j * A + rec[r]];
      double next_mse = dist[j * A + rec[r + 1]];
      if (next_mse < mse) {
        ++r;
        bounds[r] = j;
      }
    }
  }

  for (int j = 0; j < states; ++j) {
    for (int i = bounds[j]; i < bounds[j + 1]; ++i) {
      out->q[i] = static_cast<uint8_t>(rec[j]);
    }
  }
  out->out_syms.resize(states);
  for (int j = 0; j < states; ++j) out->out_syms[j] = static_cast<uint8_t>(rec[j]);
}

// Entropy of the quantized pmf, ascending-index accumulation over the full
// alphabet (quantizer.c:139-161 + pmf.c:141-155).
static double quantized_entropy(const Quant& q, const double* pmf) {
  double out[A] = {0.0};
  for (int i = 0; i < A; ++i) out[q.q[i]] += pmf[i];
  double h = 0.0;
  for (int i = 0; i < A; ++i) {
    if (out[i] > 0.0) h -= out[i] * log2(out[i]);
  }
  return h;
}

static double entropy_of(const double* pmf) {
  double h = 0.0;
  for (int i = 0; i < A; ++i) {
    if (pmf[i] > 0.0) h -= pmf[i] * log2(pmf[i]);
  }
  return h;
}

// One state-count sweep task: a context pmf + entropy target, producing
// the reference-identical (lo, hi, ratio) selection.
struct SweepTask {
  const double* pmf;
  double target;
  Quant* lo;
  Quant* hi;
  double ratio = 1.0;
};

// Speculative states evaluation, selection rule kept EXACTLY
// (codebook.c:230-269). The reference sweeps states = 1, 2, ... per
// context and stops at the first count whose quantized output entropy
// reaches the target. Each candidate's quantizer is a pure function of
// (pmf, states), so candidates can be designed in parallel WAVES across
// all live contexts and the reference loop replayed in order afterwards
// — speculated candidates past the stop point are discarded, never
// consulted, and the chosen (lo, hi, ratio) doubles are bit-identical
// by construction. This fills otherwise-idle cores when distinct
// contexts << threads (high-rate designs: few contexts, deep sweeps —
// the -c 4 -f 0.85 worst case that motivated it).
// Reference-exact sequential sweep for one task (codebook.c:230-269).
static void sweep_one(SweepTask& t, const double* dist,
                      const double* dist_t) {
  if (t.target == 0.0) {
    lloyd_max(t.pmf, dist, dist_t, 1, t.lo);
    lloyd_max(t.pmf, dist, dist_t, 1, t.hi);
    t.ratio = 1.0;
    return;
  }
  int states = 1;
  lloyd_max(t.pmf, dist, dist_t, states, t.hi);
  double hi_h = quantized_entropy(*t.hi, t.pmf);
  double lo_h = hi_h;
  for (;;) {
    *t.lo = *t.hi;
    lo_h = hi_h;
    ++states;
    lloyd_max(t.pmf, dist, dist_t, states, t.hi);
    hi_h = quantized_entropy(*t.hi, t.pmf);
    if (!(hi_h < t.target && states < A)) break;
  }
  if (hi_h < t.target) t.ratio = 0.0;
  else if (lo_h >= t.target || hi_h == lo_h) t.ratio = 1.0;
  else t.ratio = (t.target - hi_h) / (lo_h - hi_h);
}

static void speculative_sweep(std::vector<SweepTask>& tasks,
                              const double* dist, const double* dist_t,
                              bool threaded) {
  size_t n = tasks.size();
  unsigned hw = std::thread::hardware_concurrency();
  if (!hw) hw = 1;
  // Enough tasks to fill the machine (or no threading budget at all):
  // the classic schedule — every context runs its own sequential sweep,
  // dynamically load-balanced, no barriers — is strictly better.
  if (!threaded || n >= hw) {
    parallel_for(n, threaded,
                 [&](size_t i) { sweep_one(tasks[i], dist, dist_t); });
    return;
  }

  struct Prog {
    int last = 0;  // last evaluated state count
    double last_h = 0.0;
    Quant last_q;
    bool done = false;
  };
  std::vector<Prog> prog(n);

  // states = 1 for every task (terminal when target == 0: the
  // reference designs the 1-state quantizer twice into lo and hi).
  parallel_for(n, threaded, [&](size_t i) {
    SweepTask& t = tasks[i];
    Prog& p = prog[i];
    lloyd_max(t.pmf, dist, dist_t, 1, &p.last_q);
    p.last = 1;
    p.last_h = quantized_entropy(p.last_q, t.pmf);
    if (t.target == 0.0) {
      *t.lo = p.last_q;
      *t.hi = p.last_q;
      t.ratio = 1.0;
      p.done = true;
    }
  });

  std::vector<size_t> live;
  for (size_t i = 0; i < n; ++i) {
    if (!prog[i].done) live.push_back(i);
  }
  struct Cand {
    size_t task;
    int states;
  };
  std::vector<Cand> cands;
  while (!live.empty()) {
    // Wave width: fill the machine. k == 1 (live >= threads, or the
    // unthreaded call) degenerates to the exact sequential sweep with
    // zero wasted designs.
    int k = threaded ? static_cast<int>(hw / live.size()) : 1;
    if (k < 1) k = 1;
    if (k > 16) k = 16;
    cands.clear();
    for (size_t i : live) {
      int lim = std::min(A, prog[i].last + k);
      for (int s = prog[i].last + 1; s <= lim; ++s) cands.push_back({i, s});
    }
    std::vector<Quant> q(cands.size());
    std::vector<double> h(cands.size());
    parallel_for(cands.size(), threaded, [&](size_t ci) {
      lloyd_max(tasks[cands[ci].task].pmf, dist, dist_t, cands[ci].states,
                &q[ci]);
      h[ci] = quantized_entropy(q[ci], tasks[cands[ci].task].pmf);
    });
    // Replay the reference loop over this wave's candidates in order.
    std::vector<size_t> still;
    size_t ci = 0;
    for (size_t i : live) {
      Prog& p = prog[i];
      SweepTask& t = tasks[i];
      for (; ci < cands.size() && cands[ci].task == i; ++ci) {
        if (p.done) continue;
        int s = cands[ci].states;
        if (!(h[ci] < t.target && s < A)) {
          double lo_h = p.last_h, hi_h = h[ci];
          *t.lo = std::move(p.last_q);
          *t.hi = std::move(q[ci]);
          if (hi_h < t.target) t.ratio = 0.0;
          else if (lo_h >= t.target || hi_h == lo_h) t.ratio = 1.0;
          else t.ratio = (t.target - hi_h) / (lo_h - hi_h);
          p.done = true;
        } else {
          p.last = s;
          p.last_h = h[ci];
          p.last_q = std::move(q[ci]);
        }
      }
      if (!p.done) still.push_back(i);
    }
    live = std::move(still);
  }
}

// ------------------------------------------------- codebook design

struct ColumnDesign {
  std::vector<uint8_t> input_syms;  // context alphabet (duplicates possible)
  std::vector<Quant> lo, hi;        // per context
  std::vector<double> ratio;
  std::vector<uint8_t> qratio;
};

// Sorted-merge union keeping duplicates within one input (pmf.c:312-357).
static std::vector<uint8_t> merge_union(const std::vector<uint8_t>& a,
                                        const std::vector<uint8_t>& b) {
  std::vector<uint8_t> out;
  out.reserve(a.size() + b.size());
  size_t i = 0, j = 0;
  while (i < a.size() && j < b.size()) {
    if (a[i] < b[j]) out.push_back(a[i++]);
    else if (a[i] == b[j]) { out.push_back(a[i]); ++i; ++j; }
    else out.push_back(b[j++]);
  }
  while (i < a.size()) out.push_back(a[i++]);
  while (j < b.size()) out.push_back(b[j++]);
  return out;
}

static void counts_to_pmf(const uint64_t* counts, double* pmf) {
  uint64_t tot = 0;
  for (int i = 0; i < A; ++i) tot += counts[i];
  if (tot == 0) {
    for (int i = 0; i < A; ++i) pmf[i] = 0.0;
    return;
  }
  double dt = static_cast<double>(tot);
  for (int i = 0; i < A; ++i) pmf[i] = static_cast<double>(counts[i]) / dt;
}

static void renormalize(double* p, size_t n) {
  double tot = 0.0;
  for (size_t i = 0; i < n; ++i) tot += p[i];
  if (tot > 0.0) {
    for (size_t i = 0; i < n; ++i) p[i] = p[i] / tot;
  }
}

// Full per-cluster design (codebook.c:355-468). Sequential over columns;
// the compute_qpmf_list inner x-sum is hoisted out of the idx loop, which
// is bit-exact because the summand only depends on (j, k) and the += order
// over j per output cell is unchanged.
static std::vector<ColumnDesign> design_cluster(
    const uint64_t* counts0, const uint64_t* cond_counts, int columns,
    int mode, double opt_ratio, const double* dist,
    bool threaded = true) {
  std::vector<ColumnDesign> books(columns);

  // Transposed distortion for the Lloyd-Max inner loop (see lloyd_max).
  std::vector<double> dist_t(static_cast<size_t>(A) * A);
  for (int i = 0; i < A; ++i) {
    for (int r = 0; r < A; ++r) dist_t[static_cast<size_t>(r) * A + i] = dist[static_cast<size_t>(i) * A + r];
  }

  // Marginal column pmfs via the chained total-probability recursion
  // (codebook.c:208-218): acc = 1.0*acc + w_j * P(.|j), j ascending.
  std::vector<std::vector<double>> marg(columns, std::vector<double>(A, 0.0));
  counts_to_pmf(counts0, marg[0].data());
  std::vector<double> cond_buf(A);
  for (int c = 1; c < columns; ++c) {
    const uint64_t* base = cond_counts + static_cast<size_t>(c - 1) * A * A;
    auto& acc = marg[c];
    for (int j = 0; j < A; ++j) {
      double w = marg[c - 1][j];
      counts_to_pmf(base + static_cast<size_t>(j) * A, cond_buf.data());
      for (int i = 0; i < A; ++i) acc[i] = 1.0 * acc[i] + w * cond_buf[i];
    }
  }

  // Column 0 (codebook.c:402-411).
  double pmf0[A];
  counts_to_pmf(counts0, pmf0);
  double target = (mode == 0) ? entropy_of(pmf0) * opt_ratio : opt_ratio;
  ColumnDesign& b0 = books[0];
  b0.input_syms = {0};
  b0.lo.resize(1);
  b0.hi.resize(1);
  std::vector<SweepTask> t0(1);
  t0[0] = {pmf0, target, &b0.lo[0], &b0.hi[0], 1.0};
  speculative_sweep(t0, dist, dist_t.data(), threaded);
  double ratio = t0[0].ratio;
  b0.lo[0].ratio = ratio;
  b0.hi[0].ratio = 1 - ratio;
  b0.ratio = {ratio};
  b0.qratio = {static_cast<uint8_t>(ratio * 128.0)};

  // prev_qpmf[x][j]: P(Q_{col-1}=union[j] | X_{col-1}=x)
  std::vector<std::vector<double>> prev_qpmf;

  for (int column = 1; column < columns; ++column) {
    ColumnDesign& prev = books[column - 1];
    size_t prev_n = prev.input_syms.size();

    // Union of previous column's output alphabets in stored order.
    std::vector<uint8_t> uni = prev.lo[0].out_syms;
    for (size_t j = 1; j < 2 * prev_n; ++j) {
      const Quant& q = (j & 1) ? prev.hi[j >> 1] : prev.lo[j >> 1];
      uni = merge_union(uni, q.out_syms);
    }
    size_t un = uni.size();

    // P(Q_i | X_i).
    std::vector<std::vector<double>> qpmf(A, std::vector<double>(un, 0.0));
    if (column == 1) {
      // compute_qpmf_quan_list (codebook.c:274-289); NOT renormalized.
      const Quant& qlo = prev.lo[0];
      const Quant& qhi = prev.hi[0];
      double r0 = prev.ratio[0];
      for (int x = 0; x < A; ++x) {
        for (size_t idx = 0; idx < un; ++idx) {
          uint8_t sym = uni[idx];
          if (qlo.q[x] == sym) qpmf[x][idx] += r0;
          if (qhi.q[x] == sym) qpmf[x][idx] += (1 - r0);
        }
      }
    } else {
      // compute_qpmf_list (codebook.c:291-330) with the hoisted x-sum.
      const uint64_t* cbase =
          cond_counts + static_cast<size_t>(column - 2) * A * A;
      std::vector<std::vector<double>> cond_prob(A, std::vector<double>(A));
      for (int x = 0; x < A; ++x) {
        counts_to_pmf(cbase + static_cast<size_t>(x) * A,
                      cond_prob[x].data());
      }
      const auto& m2 = marg[column - 2];
      std::vector<std::vector<double>> p_temp(
          prev_n, std::vector<double>(A, 0.0));
      for (size_t j = 0; j < prev_n; ++j) {
        for (int k = 0; k < A; ++k) {
          double acc = 0.0;
          for (int x = 0; x < A; ++x) {
            acc += prev_qpmf[x][j] * cond_prob[x][k] * m2[x];
          }
          p_temp[j][k] = acc;
        }
      }
      for (int k = 0; k < A; ++k) {
        auto& row = qpmf[k];
        for (size_t idx = 0; idx < un; ++idx) {
          uint8_t sym = uni[idx];
          for (size_t j = 0; j < prev_n; ++j) {
            double p_q_xq = 0.0;
            if (prev.lo[j].q[k] == sym) p_q_xq += prev.lo[j].ratio;
            if (prev.hi[j].q[k] == sym) p_q_xq += prev.hi[j].ratio;
            row[idx] += p_q_xq * p_temp[j][k];
          }
        }
        renormalize(row.data(), un);
      }
    }

    // P(X_{i+1} | Q_i) (codebook.c:332-349).
    const uint64_t* xbase =
        cond_counts + static_cast<size_t>(column - 1) * A * A;
    std::vector<std::vector<double>> cond_prob_x(A, std::vector<double>(A));
    for (int x = 0; x < A; ++x) {
      counts_to_pmf(xbase + static_cast<size_t>(x) * A,
                    cond_prob_x[x].data());
    }
    const auto& m1 = marg[column - 1];
    std::vector<std::vector<double>> xpmf(un, std::vector<double>(A, 0.0));
    for (size_t idx = 0; idx < un; ++idx) {
      auto& row = xpmf[idx];
      for (int k = 0; k < A; ++k) {
        double acc = 0.0;
        for (int x = 0; x < A; ++x) {
          acc += qpmf[x][idx] * cond_prob_x[x][k] * m1[x];
        }
        row[k] = acc;
      }
      renormalize(row.data(), A);
    }

    // Per-context optimization (codebook.c:441-454).
    ColumnDesign& b = books[column];
    b.input_syms = uni;
    b.lo.resize(un);
    b.hi.resize(un);
    b.ratio.resize(un);
    b.qratio.resize(un);
    // Byte-identical xpmf rows produce byte-identical designs (the
    // whole sweep is a deterministic function of the row), and
    // degenerate/duplicate contexts are common at high rates — design
    // each distinct row once and copy.
    std::unordered_map<std::string, size_t> seen;
    std::vector<size_t> rep(un);
    std::vector<size_t> uniq;
    for (size_t j = 0; j < un; ++j) {
      std::string key(reinterpret_cast<const char*>(xpmf[j].data()),
                      A * sizeof(double));
      auto it = seen.emplace(std::move(key), j);
      rep[j] = it.first->second;
      if (it.second) uniq.push_back(j);
    }

    // Contexts are independent designs with disjoint outputs, so the
    // parallel/speculative schedule cannot change any double result.
    std::vector<SweepTask> tasks(uniq.size());
    for (size_t uj = 0; uj < uniq.size(); ++uj) {
      size_t j = uniq[uj];
      double tgt = (mode == 0) ? entropy_of(xpmf[j].data()) * opt_ratio
                               : opt_ratio;
      tasks[uj] = {xpmf[j].data(), tgt, &b.lo[j], &b.hi[j], 1.0};
    }
    speculative_sweep(tasks, dist, dist_t.data(), threaded);
    for (size_t uj = 0; uj < uniq.size(); ++uj) {
      size_t j = uniq[uj];
      double rj = tasks[uj].ratio;
      b.lo[j].ratio = rj;
      b.hi[j].ratio = 1 - rj;
      b.ratio[j] = rj;
      b.qratio[j] = static_cast<uint8_t>(rj * 128.0);
    }
    for (size_t j = 0; j < un; ++j) {
      if (rep[j] != j) {
        b.lo[j] = b.lo[rep[j]];
        b.hi[j] = b.hi[rep[j]];
        b.ratio[j] = b.ratio[rep[j]];
        b.qratio[j] = b.qratio[rep[j]];
      }
    }

    prev_qpmf = std::move(qpmf);
  }

  return books;
}

// Serialize one cluster's codebook block (codebook.c:474-555 format).
static void serialize_books(const std::vector<ColumnDesign>& books,
                            std::string* out) {
  const ColumnDesign& b0 = books[0];
  out->push_back(static_cast<char>(b0.qratio[0] + 33));
  out->push_back('\n');
  for (int i = 0; i < A; ++i) out->push_back(static_cast<char>(b0.lo[0].q[i] + 33));
  out->push_back('\n');
  for (int i = 0; i < A; ++i) out->push_back(static_cast<char>(b0.hi[0].q[i] + 33));
  out->push_back('\n');
  for (size_t c = 1; c < books.size(); ++c) {
    const ColumnDesign& b = books[c];
    for (uint8_t qr : b.qratio) out->push_back(static_cast<char>(qr + 33));
    out->push_back('\n');
    for (const Quant& q : b.lo) {
      for (int i = 0; i < A; ++i) out->push_back(static_cast<char>(q.q[i] + 33));
    }
    out->push_back('\n');
    for (const Quant& q : b.hi) {
      for (int i = 0; i < A; ++i) out->push_back(static_cast<char>(q.q[i] + 33));
    }
    out->push_back('\n');
  }
}

// ------------------------------------------------- coding tables

// Adjacent-deduplication output alphabet (quantizer.c:167-191).
static std::vector<uint8_t> adjacent_unique(const uint8_t* q) {
  std::vector<uint8_t> u;
  u.push_back(q[0]);
  for (int x = 1; x < A; ++x) {
    if (q[x] != u.back()) u.push_back(q[x]);
  }
  return u;
}

// Flat coding tables shared by the encoder and decoder. Pair index
// p = pair_base[cluster*columns + col] + ctx; model id = 1 + 2p + choice
// (model 0 is the cluster-id model).
struct Tables {
  uint32_t n_clusters = 0;
  uint32_t columns = 0;
  uint64_t n_pairs = 0;
  uint32_t n_models = 0;
  int64_t consumed = 0;  // bytes of the parsed codebook blocks

  std::vector<uint32_t> pair_base;   // [n_clusters*columns]
  std::vector<int32_t> ctxmap;       // [n_clusters*columns*A] prev -> ctx
  std::vector<uint8_t> qratio;       // [n_pairs]
  std::vector<uint32_t> model_card;  // [n_models]
  std::vector<uint64_t> model_off;   // [n_models+1] into model_syms
  std::vector<uint8_t> model_syms;   // output alphabets, flat
  std::vector<uint8_t> qv_map;       // [n_pairs*2*A] symbol -> quantized
  std::vector<uint8_t> qs_map;       // [n_pairs*2*A] symbol -> state index
};

// Index table with last-wins semantics (pmf.c:365-382).
static void fill_index(const std::vector<uint8_t>& syms, int32_t* idx) {
  for (int i = 0; i < A; ++i) idx[i] = -1;
  for (size_t i = 0; i < syms.size(); ++i) idx[syms[i]] = static_cast<int32_t>(i);
}

// Append one quantizer's tables given its output alphabet.
static void append_quant_tables(Tables* tb, const uint8_t* qmap,
                                const std::vector<uint8_t>& out_syms) {
  int32_t sym_idx[A];
  fill_index(out_syms, sym_idx);
  tb->model_card.push_back(static_cast<uint32_t>(out_syms.size()));
  tb->model_off.push_back(tb->model_off.back() + out_syms.size());
  tb->model_syms.insert(tb->model_syms.end(), out_syms.begin(),
                        out_syms.end());
  for (int i = 0; i < A; ++i) {
    tb->qv_map.push_back(qmap[i]);
    tb->qs_map.push_back(static_cast<uint8_t>(sym_idx[qmap[i]]));
  }
}

// Build tables from designed books (encoder path: output alphabets are the
// raw reconstruction arrays).
static Tables* tables_from_design(
    const std::vector<std::vector<ColumnDesign>>& all, uint32_t columns) {
  Tables* tb = new Tables();
  tb->n_clusters = static_cast<uint32_t>(all.size());
  tb->columns = columns;
  tb->model_off.push_back(0);
  tb->model_card.push_back(tb->n_clusters);  // model 0: cluster ids
  tb->model_off.push_back(tb->n_clusters);
  for (uint32_t c = 0; c < tb->n_clusters; ++c) {
    tb->model_syms.push_back(static_cast<uint8_t>(c));
  }
  for (uint32_t cl = 0; cl < tb->n_clusters; ++cl) {
    const auto& books = all[cl];
    for (uint32_t col = 0; col < columns; ++col) {
      const ColumnDesign& b = books[col];
      tb->pair_base.push_back(static_cast<uint32_t>(tb->n_pairs));
      int32_t* cm = nullptr;
      tb->ctxmap.resize(tb->ctxmap.size() + A, -1);
      cm = tb->ctxmap.data() + tb->ctxmap.size() - A;
      fill_index(b.input_syms, cm);
      for (size_t j = 0; j < b.input_syms.size(); ++j) {
        tb->qratio.push_back(b.qratio[j]);
        append_quant_tables(tb, b.lo[j].q, b.lo[j].out_syms);
        append_quant_tables(tb, b.hi[j].q, b.hi[j].out_syms);
        ++tb->n_pairs;
      }
    }
  }
  tb->n_models = static_cast<uint32_t>(tb->model_card.size());
  return tb;
}

// Parse serialized codebook blocks (decoder path: output alphabets come
// from adjacent-dedup of the maps, contexts from running unions,
// codebook.c:586-669).
static Tables* tables_from_blocks(const uint8_t* data, int64_t len,
                                  uint32_t n_clusters, uint32_t columns) {
  Tables* tb = new Tables();
  tb->n_clusters = n_clusters;
  tb->columns = columns;
  tb->model_off.push_back(0);
  tb->model_card.push_back(n_clusters);
  tb->model_off.push_back(n_clusters);
  for (uint32_t c = 0; c < n_clusters; ++c) {
    tb->model_syms.push_back(static_cast<uint8_t>(c));
  }

  int64_t pos = 0;
  auto need = [&](int64_t n) { return pos + n <= len; };

  for (uint32_t cl = 0; cl < n_clusters; ++cl) {
    if (!need(2 + 2 * (A + 1))) { delete tb; return nullptr; }
    // Column 0.
    uint8_t qr0 = static_cast<uint8_t>(data[pos] - 33);
    pos += 2;  // ratio byte + newline
    uint8_t lo_map[A], hi_map[A];
    bool ok = true;
    for (int i = 0; i < A; ++i) {
      lo_map[i] = static_cast<uint8_t>(data[pos + i] - 33);
      ok &= lo_map[i] < A;
    }
    pos += A + 1;
    for (int i = 0; i < A; ++i) {
      hi_map[i] = static_cast<uint8_t>(data[pos + i] - 33);
      ok &= hi_map[i] < A;
    }
    pos += A + 1;
    if (!ok) { delete tb; return nullptr; }

    tb->pair_base.push_back(static_cast<uint32_t>(tb->n_pairs));
    tb->ctxmap.resize(tb->ctxmap.size() + A, -1);
    {
      std::vector<uint8_t> in0 = {0};
      fill_index(in0, tb->ctxmap.data() + tb->ctxmap.size() - A);
    }
    std::vector<uint8_t> lo_out = adjacent_unique(lo_map);
    std::vector<uint8_t> hi_out = adjacent_unique(hi_map);
    tb->qratio.push_back(qr0);
    append_quant_tables(tb, lo_map, lo_out);
    append_quant_tables(tb, hi_map, hi_out);
    ++tb->n_pairs;

    std::vector<uint8_t> uniques = merge_union(lo_out, hi_out);

    for (uint32_t col = 1; col < columns; ++col) {
      size_t size = uniques.size();
      tb->pair_base.push_back(static_cast<uint32_t>(tb->n_pairs));
      tb->ctxmap.resize(tb->ctxmap.size() + A, -1);
      fill_index(uniques, tb->ctxmap.data() + tb->ctxmap.size() - A);

      if (!need(static_cast<int64_t>(size) * (1 + 2 * A) + 3)) {
        delete tb;
        return nullptr;
      }
      std::vector<uint8_t> qrs(size);
      for (size_t i = 0; i < size; ++i) qrs[i] = static_cast<uint8_t>(data[pos + i] - 33);
      pos += static_cast<int64_t>(size) + 1;

      std::vector<std::vector<uint8_t>> lo_maps(size), hi_maps(size);
      std::vector<std::vector<uint8_t>> lo_outs(size), hi_outs(size);
      std::vector<uint8_t> next_uniques;
      bool ok = true;
      for (size_t i = 0; i < size; ++i) {
        lo_maps[i].resize(A);
        for (int k = 0; k < A; ++k) {
          lo_maps[i][k] = static_cast<uint8_t>(data[pos + k] - 33);
          ok &= lo_maps[i][k] < A;
        }
        pos += A;
        lo_outs[i] = adjacent_unique(lo_maps[i].data());
        next_uniques = merge_union(next_uniques, lo_outs[i]);
      }
      pos += 1;  // newline
      for (size_t i = 0; i < size; ++i) {
        hi_maps[i].resize(A);
        for (int k = 0; k < A; ++k) {
          hi_maps[i][k] = static_cast<uint8_t>(data[pos + k] - 33);
          ok &= hi_maps[i][k] < A;
        }
        pos += A;
        hi_outs[i] = adjacent_unique(hi_maps[i].data());
        next_uniques = merge_union(next_uniques, hi_outs[i]);
      }
      pos += 1;  // newline
      if (!ok) { delete tb; return nullptr; }

      for (size_t i = 0; i < size; ++i) {
        tb->qratio.push_back(qrs[i]);
        append_quant_tables(tb, lo_maps[i].data(), lo_outs[i]);
        append_quant_tables(tb, hi_maps[i].data(), hi_outs[i]);
        ++tb->n_pairs;
      }
      uniques = std::move(next_uniques);
    }
  }
  tb->n_models = static_cast<uint32_t>(tb->model_card.size());
  tb->consumed = pos;
  return tb;
}

}  // namespace

// =================================================================== C API

extern "C" {

// --- WELL draws -------------------------------------------------------

void qvz_well_draws7(const uint32_t* state, uint64_t n_draws, uint8_t* out) {
  Well w(state);
  for (uint64_t i = 0; i < n_draws; ++i) {
    out[i] = static_cast<uint8_t>(w.draw7());
  }
}

// --- integrity hash -------------------------------------------------------

// XXH64 (Yann Collet's public-domain spec). Used for the QVZ2 container's
// per-shard payload checksums — a framework extension; the reference has
// no integrity checking anywhere (src/os_stream.c writes raw bytes), so a
// flipped payload byte silently mis-decodes there. Not cryptographic;
// corruption detection only.
static inline uint64_t xxh_rotl64(uint64_t x, int r) {
  return (x << r) | (x >> (64 - r));
}

uint64_t qvz_xxh64(const uint8_t* p, uint64_t len, uint64_t seed) {
  static const uint64_t P1 = 0x9E3779B185EBCA87ULL;
  static const uint64_t P2 = 0xC2B2AE3D27D4EB4FULL;
  static const uint64_t P3 = 0x165667B19E3779F9ULL;
  static const uint64_t P4 = 0x85EBCA77C2B2AE63ULL;
  static const uint64_t P5 = 0x27D4EB2F165667C5ULL;
  const uint8_t* end = p + len;
  uint64_t h;
  auto read64 = [](const uint8_t* q) {
    uint64_t v;
    std::memcpy(&v, q, 8);
    return v;  // little-endian hosts only (x86/arm LE)
  };
  auto read32 = [](const uint8_t* q) {
    uint32_t v;
    std::memcpy(&v, q, 4);
    return static_cast<uint64_t>(v);
  };
  auto round = [](uint64_t acc, uint64_t input) {
    acc += input * P2;
    acc = xxh_rotl64(acc, 31);
    return acc * P1;
  };
  if (len >= 32) {
    uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
    const uint8_t* limit = end - 32;
    do {
      v1 = round(v1, read64(p));
      v2 = round(v2, read64(p + 8));
      v3 = round(v3, read64(p + 16));
      v4 = round(v4, read64(p + 24));
      p += 32;
    } while (p <= limit);
    h = xxh_rotl64(v1, 1) + xxh_rotl64(v2, 7) + xxh_rotl64(v3, 12) +
        xxh_rotl64(v4, 18);
    auto merge = [&](uint64_t acc, uint64_t val) {
      acc ^= round(0, val);
      return acc * P1 + P4;
    };
    h = merge(h, v1);
    h = merge(h, v2);
    h = merge(h, v3);
    h = merge(h, v4);
  } else {
    h = seed + P5;
  }
  h += len;
  while (p + 8 <= end) {
    h ^= round(0, read64(p));
    h = xxh_rotl64(h, 27) * P1 + P4;
    p += 8;
  }
  if (p + 4 <= end) {
    h ^= read32(p) * P1;
    h = xxh_rotl64(h, 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h ^= (*p++) * P5;
    h = xxh_rotl64(h, 11) * P1;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// --- codebook design ----------------------------------------------------

// Opaque design handle: designed books for all clusters + serialization.
struct QvzDesign {
  std::vector<std::vector<ColumnDesign>> books;
  std::string serialized;
  uint32_t columns = 0;
};

void* qvz_design_create(const uint64_t* counts0,      // [n_clusters*72]
                        const uint64_t* cond_counts,  // [n_clusters*(cols-1)*72*72]
                        uint32_t n_clusters, uint32_t columns, int32_t mode,
                        double ratio, const double* dist) {
  QvzDesign* d = new QvzDesign();
  d->columns = columns;
  size_t cond_stride = static_cast<size_t>(columns - 1) * A * A;
  d->books.resize(n_clusters);
  // Clusters are fully independent; thread across them when there are
  // several, else across contexts inside each column.
  bool outer = n_clusters >= std::thread::hardware_concurrency();
  parallel_for(n_clusters, outer, [&](size_t c) {
    d->books[c] = design_cluster(counts0 + c * A,
                                 cond_counts + c * cond_stride,
                                 static_cast<int>(columns), mode, ratio,
                                 dist, /*threaded=*/!outer);
  });
  for (uint32_t c = 0; c < n_clusters; ++c) {
    serialize_books(d->books[c], &d->serialized);
  }
  return d;
}

int64_t qvz_design_serialized_size(void* h) {
  return static_cast<int64_t>(static_cast<QvzDesign*>(h)->serialized.size());
}

void qvz_design_serialized(void* h, uint8_t* out) {
  QvzDesign* d = static_cast<QvzDesign*>(h);
  std::memcpy(out, d->serialized.data(), d->serialized.size());
}

void qvz_design_free(void* h) { delete static_cast<QvzDesign*>(h); }

// --- coding tables -------------------------------------------------------

void* qvz_tables_from_design(void* design_handle) {
  QvzDesign* d = static_cast<QvzDesign*>(design_handle);
  return tables_from_design(d->books, d->columns);
}

void* qvz_tables_from_blocks(const uint8_t* blocks, int64_t len,
                             uint32_t n_clusters, uint32_t columns) {
  return tables_from_blocks(blocks, len, n_clusters, columns);
}

void qvz_tables_free(void* h) { delete static_cast<Tables*>(h); }

uint64_t qvz_tables_n_pairs(void* h) { return static_cast<Tables*>(h)->n_pairs; }
uint32_t qvz_tables_n_models(void* h) { return static_cast<Tables*>(h)->n_models; }
int64_t qvz_tables_consumed(void* h) { return static_cast<Tables*>(h)->consumed; }
const uint32_t* qvz_tables_pair_base(void* h) { return static_cast<Tables*>(h)->pair_base.data(); }
const int32_t* qvz_tables_ctxmap(void* h) { return static_cast<Tables*>(h)->ctxmap.data(); }
const uint8_t* qvz_tables_qratio(void* h) { return static_cast<Tables*>(h)->qratio.data(); }
const uint32_t* qvz_tables_model_card(void* h) { return static_cast<Tables*>(h)->model_card.data(); }
const uint64_t* qvz_tables_model_off(void* h) { return static_cast<Tables*>(h)->model_off.data(); }
const uint8_t* qvz_tables_model_syms(void* h) { return static_cast<Tables*>(h)->model_syms.data(); }
uint64_t qvz_tables_model_syms_len(void* h) { return static_cast<Tables*>(h)->model_syms.size(); }

// u32 words in a ModelBank snapshot blob for these tables
// (sum of cards + one total per model).
uint64_t qvz_tables_bank_words(void* h) {
  Tables* tb = static_cast<Tables*>(h);
  uint64_t w = tb->n_models;
  for (uint32_t m = 0; m < tb->n_models; ++m) w += tb->model_card[m];
  return w;
}
const uint8_t* qvz_tables_qv_map(void* h) { return static_cast<Tables*>(h)->qv_map.data(); }
const uint8_t* qvz_tables_qs_map(void* h) { return static_cast<Tables*>(h)->qs_map.data(); }

// --- quantization (host path; the device path is ops/quantize.py) --------

void qvz_quantize(void* tables, const uint8_t* data, uint64_t n_lines,
                  const uint8_t* cluster_ids, const uint8_t* draws,
                  uint32_t* model_ids, uint8_t* syms, uint8_t* recon) {
  Tables* tb = static_cast<Tables*>(tables);
  uint32_t columns = tb->columns;
  for (uint64_t i = 0; i < n_lines; ++i) {
    uint32_t cl = cluster_ids ? cluster_ids[i] : 0;
    const uint8_t* row = data + i * columns;
    const uint8_t* drow = draws + i * columns;
    uint32_t* mrow = model_ids + i * columns;
    uint8_t* srow = syms + i * columns;
    uint8_t* rrow = recon ? recon + i * columns : nullptr;
    uint32_t prev = 0;
    uint64_t cbase = static_cast<uint64_t>(cl) * columns;
    for (uint32_t col = 0; col < columns; ++col) {
      int32_t ctx = tb->ctxmap[(cbase + col) * A + prev];
      uint64_t p = tb->pair_base[cbase + col] + static_cast<uint32_t>(ctx);
      uint32_t choice = drow[col] >= tb->qratio[p] ? 1u : 0u;
      const uint8_t* qv = tb->qv_map.data() + (p * 2 + choice) * A;
      const uint8_t* qs = tb->qs_map.data() + (p * 2 + choice) * A;
      uint8_t d = row[col];
      mrow[col] = 1 + 2 * static_cast<uint32_t>(p) + choice;
      srow[col] = qs[d];
      if (rrow) rrow[col] = qv[d];
      prev = qv[d];
    }
  }
}

// Line-structured encode: cluster symbol then each column's symbol, the
// exact stream order of qv_compressor.c:76-137. model_ids/syms hold only
// the per-column entries; cluster ids are coded with model 0.
int64_t qvz_encode_lines(const uint8_t* cluster_ids, const uint32_t* model_ids,
                         const uint8_t* syms, uint64_t n_lines,
                         uint32_t columns, const uint32_t* model_cards,
                         uint32_t n_models, uint8_t* out, int64_t cap) {
  ModelBank bank;
  bank.init(model_cards, n_models);
  BitWriter bw(out, cap);
  Encoder enc(&bw);
  for (uint64_t i = 0; i < n_lines; ++i) {
    uint32_t c = cluster_ids ? cluster_ids[i] : 0;
    enc.step(bank, 0, c);
    bank.update(0, c);
    const uint32_t* mrow = model_ids + i * columns;
    const uint8_t* srow = syms + i * columns;
    for (uint32_t col = 0; col < columns; ++col) {
      uint32_t m = mrow[col];
      uint32_t x = srow[col];
      enc.step(bank, m, x);
      bank.update(m, x);
    }
  }
  int64_t n = enc.finish();
  if (bw.overflow) return -n;
  return n;
}

}  // extern "C"

// --- WELL GF(2) jump-ahead ------------------------------------------------

// One next_word() call is linear over GF(2) on the 1024-bit state when the
// state is expressed in n-relative word order: vector bit (32*i + b) = bit
// b of word (n+i)&31 (layout matches ops/well.py _state_to_vec). Powers
// M^(2^k) are state-independent, computed once per process.

namespace welljump {

constexpr int kBits = 1024;
constexpr int kWpr = kBits / 64;  // uint64 words per row

struct Mat {
  std::vector<uint64_t> r;  // [kBits * kWpr], row-major bit rows
  Mat() : r(static_cast<size_t>(kBits) * kWpr, 0) {}
  inline uint64_t* row(int i) { return r.data() + static_cast<size_t>(i) * kWpr; }
  inline const uint64_t* row(int i) const { return r.data() + static_cast<size_t>(i) * kWpr; }
};

static void state_to_vec(const uint32_t* s, uint32_t n, uint64_t* v) {
  for (int w = 0; w < kWpr; ++w) v[w] = 0;
  for (int i = 0; i < 32; ++i) {
    uint64_t word = s[(n + i) & 31];
    v[i / 2] |= word << (32 * (i & 1));
  }
}

static void vec_to_state(const uint64_t* v, uint32_t* s) {
  for (int i = 0; i < 32; ++i) {
    s[i] = static_cast<uint32_t>((v[i / 2] >> (32 * (i & 1))) & 0xFFFFFFFFull);
  }
}

// M: new_vec = M . vec for one word() step, built from basis states.
static Mat step_matrix() {
  // cols[j] = M e_j, then transpose into bit rows.
  std::vector<uint64_t> cols(static_cast<size_t>(kBits) * kWpr, 0);
  for (int j = 0; j < kBits; ++j) {
    uint32_t words[32] = {0};
    words[j / 32] = 1u << (j % 32);
    Well w(words);
    w.word();
    state_to_vec(w.s, w.n, cols.data() + static_cast<size_t>(j) * kWpr);
  }
  Mat m;
  for (int j = 0; j < kBits; ++j) {
    const uint64_t* c = cols.data() + static_cast<size_t>(j) * kWpr;
    for (int w = 0; w < kWpr; ++w) {
      uint64_t x = c[w];
      while (x) {
        int b = __builtin_ctzll(x);
        x &= x - 1;
        int i = w * 64 + b;
        m.row(i)[j / 64] |= 1ull << (j % 64);
      }
    }
  }
  return m;
}

static Mat matmul(const Mat& a, const Mat& b) {
  // Method of four Russians: per 8-column block, precompute all 256 XOR
  // combinations of b's rows, then one table lookup per (row, block).
  Mat out;
  std::vector<uint64_t> tbl(256 * kWpr);
  for (int p = 0; p < kBits / 8; ++p) {
    for (int w = 0; w < kWpr; ++w) tbl[w] = 0;
    for (int v = 1; v < 256; ++v) {
      int low = v & -v;
      const uint64_t* br = b.row(8 * p + __builtin_ctz(low));
      const uint64_t* prev = &tbl[static_cast<size_t>(v ^ low) * kWpr];
      uint64_t* dst = &tbl[static_cast<size_t>(v) * kWpr];
      for (int w = 0; w < kWpr; ++w) dst[w] = prev[w] ^ br[w];
    }
    int word = p / 8, shift = 8 * (p % 8);
    for (int i = 0; i < kBits; ++i) {
      uint32_t byte = (a.row(i)[word] >> shift) & 0xFF;
      if (byte) {
        const uint64_t* src = &tbl[static_cast<size_t>(byte) * kWpr];
        uint64_t* orow = out.row(i);
        for (int w = 0; w < kWpr; ++w) orow[w] ^= src[w];
      }
    }
  }
  return out;
}

static void matvec(const Mat& m, const uint64_t* v, uint64_t* out) {
  for (int w = 0; w < kWpr; ++w) out[w] = 0;
  for (int i = 0; i < kBits; ++i) {
    const uint64_t* r = m.row(i);
    uint64_t acc = 0;
    for (int k = 0; k < kWpr; ++k) acc ^= r[k] & v[k];
    out[i / 64] |= static_cast<uint64_t>(__builtin_parityll(acc)) << (i % 64);
  }
}

// Full M^(2^k) table for k in [0, 63], built once under std::call_once:
// ctypes releases the GIL during foreign calls, so concurrent
// qvz_well_jump calls (e.g. two api.compress calls with shards>1 from
// different threads) must not race on table growth. Eager full build
// (~64 four-Russians matmuls, ~0.1 s, 8 MB) beats any locked lazy
// scheme: after the one-time build every read is lock-free and no
// reallocation can invalidate a concurrent reader.
static const std::vector<Mat>& pow_table() {
  static std::vector<Mat> t;
  static std::once_flag built;
  std::call_once(built, [] {
    t.reserve(64);
    t.push_back(step_matrix());
    while (t.size() < 64) t.push_back(matmul(t.back(), t.back()));
  });
  return t;
}

static const Mat& pow2(int k) {
  return pow_table()[k];
}

}  // namespace welljump

extern "C" {

// Start states for n_chunks contiguous word-chunks of one WELL stream.
// state: 32 words with n=0 semantics; chunk c's 32-word state (also n=0
// semantics) lands at out + 32*c. Chunk 0 is `state` itself.
void qvz_well_jump(const uint32_t* state, uint32_t n_chunks,
                   uint64_t words_per_chunk, uint32_t* out) {
  using namespace welljump;
  uint64_t v[kWpr], tmp[kWpr];
  state_to_vec(state, 0, v);
  int bits[64];
  int nb = 0;
  for (int k = 0; k < 64; ++k) {
    if ((words_per_chunk >> k) & 1) bits[nb++] = k;
  }
  if (nb) pow_table();  // one-time full build (thread-safe)
  for (uint32_t c = 0; c < n_chunks; ++c) {
    vec_to_state(v, out + 32ull * c);
    if (c + 1 < n_chunks) {
      for (int i = 0; i < nb; ++i) {
        matvec(pow2(bits[i]), v, tmp);
        std::memcpy(v, tmp, sizeof(v));
      }
    }
  }
}

}  // extern "C"

extern "C" {
// --- host statistics ------------------------------------------------------

// Single-pass conditional histogram (codebook.c:185-203 semantics). Host
// fallback for when the device path isn't beneficial (small inputs or a
// slow host<->device link). counts0: [n_clusters*A] u64; cond:
// [n_clusters*(columns-1)*A*A] u64, both zero-initialized by the caller.
void qvz_stats(const uint8_t* data, uint64_t n_lines, uint32_t columns,
               const uint8_t* cluster_ids, uint64_t* counts0,
               uint64_t* cond) {
  uint64_t cond_stride = static_cast<uint64_t>(columns - 1) * A * A;
  auto accumulate = [&](uint64_t lo, uint64_t hi, uint64_t* c0,
                        uint64_t* cd) {
    for (uint64_t i = lo; i < hi; ++i) {
      uint32_t c = cluster_ids ? cluster_ids[i] : 0;
      const uint8_t* row = data + i * columns;
      c0[static_cast<uint64_t>(c) * A + row[0]] += 1;
      uint64_t* cc = cd + static_cast<uint64_t>(c) * cond_stride;
      for (uint32_t col = 1; col < columns; ++col) {
        cc[(static_cast<uint64_t>(col - 1) * A + row[col - 1]) * A +
           row[col]] += 1;
      }
    }
  };
  // Thread over row blocks with private accumulators; the integer
  // merges are exact in any order. n_clusters is implicit in the array
  // sizes, so each thread allocates a single-cluster-span scratch only
  // when cluster_ids is null — with clusters we derive the span from
  // the maximum id (counts arrays were sized by the caller).
  unsigned hw = std::thread::hardware_concurrency();
  uint64_t min_per = 1u << 16;
  size_t nt = hw ? hw : 1;
  if (n_lines / nt < min_per) nt = std::max<uint64_t>(1, n_lines / min_per);
  if (nt <= 1) {
    accumulate(0, n_lines, counts0, cond);
    return;
  }
  uint32_t n_clusters = 1;
  if (cluster_ids) {
    uint8_t mx = 0;
    for (uint64_t i = 0; i < n_lines; ++i) mx = std::max(mx, cluster_ids[i]);
    n_clusters = mx + 1u;
  }
  size_t c0_len = static_cast<size_t>(n_clusters) * A;
  size_t cd_len = static_cast<size_t>(n_clusters) * cond_stride;
  std::vector<std::vector<uint64_t>> p0(nt), pc(nt);
  std::vector<std::thread> ts;
  uint64_t block = (n_lines + nt - 1) / nt;
  for (size_t t = 0; t < nt; ++t) {
    ts.emplace_back([&, t] {
      p0[t].assign(c0_len, 0);
      pc[t].assign(cd_len, 0);
      uint64_t lo = t * block, hi = std::min(n_lines, lo + block);
      if (lo < hi) accumulate(lo, hi, p0[t].data(), pc[t].data());
    });
  }
  for (auto& th : ts) th.join();
  for (size_t t = 0; t < nt; ++t) {
    for (size_t k = 0; k < c0_len; ++k) counts0[k] += p0[t][k];
    for (size_t k = 0; k < cd_len; ++k) cond[k] += pc[t][k];
  }
}

// --- host k-means ---------------------------------------------------------

// One Lloyd iteration (cluster.c:136-171 + 80-113 semantics): first-min
// integer-distance assignment and integer centroid accumulators.
// Threaded over row blocks; per-thread partial sums merge as exact
// integer adds (order-free). Caller owns the convergence loop.
void qvz_kmeans_iter(const uint8_t* data, uint64_t n_lines, uint32_t cols,
                     const int64_t* means, uint32_t k, uint8_t* assign,
                     int64_t* sums, int64_t* counts) {
  unsigned hw = std::thread::hardware_concurrency();
  size_t nt = std::max(1u, hw);
  uint64_t block = (n_lines + nt - 1) / nt;
  nt = (n_lines + block - 1) / block;
  std::vector<std::vector<int64_t>> psums(nt);
  std::vector<std::vector<int64_t>> pcounts(nt);
  std::vector<std::thread> ts;
  for (size_t t = 0; t < nt; ++t) {
    ts.emplace_back([&, t] {
      uint64_t lo = t * block, hi = std::min(n_lines, lo + block);
      auto& ms = psums[t];
      auto& mc = pcounts[t];
      ms.assign(static_cast<size_t>(k) * cols, 0);
      mc.assign(k, 0);
      for (uint64_t i = lo; i < hi; ++i) {
        const uint8_t* row = data + i * cols;
        int64_t best = INT64_MAX;
        uint32_t best_c = 0;
        for (uint32_t c = 0; c < k; ++c) {
          const int64_t* m = means + static_cast<size_t>(c) * cols;
          int64_t d = 0;
          for (uint32_t j = 0; j < cols; ++j) {
            int64_t diff = static_cast<int64_t>(row[j]) - m[j];
            d += diff * diff;
          }
          if (d < best) {
            best = d;
            best_c = c;
          }
        }
        assign[i] = static_cast<uint8_t>(best_c);
        mc[best_c] += 1;
        int64_t* s = ms.data() + static_cast<size_t>(best_c) * cols;
        for (uint32_t j = 0; j < cols; ++j) s[j] += row[j];
      }
    });
  }
  for (auto& th : ts) th.join();
  std::fill(sums, sums + static_cast<size_t>(k) * cols, 0);
  std::fill(counts, counts + k, 0);
  for (size_t t = 0; t < nt; ++t) {
    for (uint32_t c = 0; c < k; ++c) counts[c] += pcounts[t][c];
    for (size_t j = 0; j < static_cast<size_t>(k) * cols; ++j) {
      sums[j] += psums[t][j];
    }
  }
}

// --- fused encode ---------------------------------------------------------

// Quantize + arithmetic-code in ONE pass over the data with inline WELL
// draws (replaces qvz_quantize + qvz_encode_lines and the draws buffer).
// Optionally accumulates distortion (dist row-major [A*A], d(x,y) at
// x*A+y; pass null to skip) and writes the lossy reconstruction (recon,
// [n_lines*columns] symbols; pass null to skip). distortion_out receives
// sum over lines of (per-line distortion sum / columns). Returns payload
// bytes, or -(needed) if the output buffer is too small.
// verbose != 0: per-million-line progress prints in the reference's
// format (qv_compressor.c:79-81).
int64_t qvz_encode_fused(void* tables, const uint8_t* data, uint64_t n_lines,
                         const uint8_t* cluster_ids,
                         const uint32_t* well_state, const double* dist,
                         uint8_t* recon, double* distortion_out,
                         uint8_t* out, int64_t cap, int32_t verbose) {
  Tables* tb = static_cast<Tables*>(tables);
  uint32_t columns = tb->columns;
  ModelBank bank;
  bank.init(tb->model_card.data(), tb->n_models);
  BitWriter bw(out, cap);
  Encoder enc(&bw);
  Well well(well_state);
  double total_d = 0.0;

  // Per-line two-pass split: quantization (context chain + dither +
  // table maps) has no dependence on coder state, so it runs as a tight
  // lookup loop first; the coder pass then streams the precomputed
  // (model, symbol) pairs with the next models prefetched — the
  // adaptive-coding recurrence is the only remaining serial chain.
  std::vector<uint32_t> mbuf(columns);
  std::vector<uint8_t> xbuf(columns);
  for (uint64_t i = 0; i < n_lines; ++i) {
    if (verbose && i % 1000000 == 0) {
      printf("Line: %dM\n", static_cast<int>(i / 1000000));
    }
    uint32_t c = cluster_ids ? cluster_ids[i] : 0;
    const uint8_t* row = data + i * columns;
    uint8_t* rrow = recon ? recon + i * columns : nullptr;
    uint32_t prev = 0;
    uint64_t cbase = static_cast<uint64_t>(c) * columns;
    double line_d = 0.0;
    for (uint32_t col = 0; col < columns; ++col) {
      int32_t ctx = tb->ctxmap[(cbase + col) * A + prev];
      uint64_t p = tb->pair_base[cbase + col] + static_cast<uint32_t>(ctx);
      uint32_t choice = well.draw7() >= tb->qratio[p] ? 1u : 0u;
      uint64_t pc = p * 2 + choice;
      uint8_t d = row[col];
      uint8_t qv = tb->qv_map[pc * A + d];
      mbuf[col] = static_cast<uint32_t>(1 + pc);
      xbuf[col] = tb->qs_map[pc * A + d];
      if (dist) line_d += dist[static_cast<uint32_t>(d) * A + qv];
      if (rrow) rrow[col] = qv;
      prev = qv;
    }
    total_d += line_d / columns;

    enc.step(bank, 0, c);
    bank.update(0, c);
    bank.prefetch(mbuf[0]);
    if (columns > 1) bank.prefetch(mbuf[1]);
    for (uint32_t col = 0; col < columns; ++col) {
      if (col + 2 < columns) bank.prefetch(mbuf[col + 2]);
      uint32_t m = mbuf[col];
      enc.step(bank, m, xbuf[col]);
      bank.update(m, xbuf[col]);
    }
  }
  if (distortion_out) *distortion_out = total_d;
  int64_t n = enc.finish();
  if (bw.overflow) return -n;
  return n;
}

// --- column-major fused encode (QVZ2 shard payloads) -----------------------

// Same quantization decisions as qvz_encode_fused (identical WELL draw
// consumption order => identical reconstruction), but the SYMBOLS are
// entropy-coded column-major: all cluster ids first, then column 0 of
// every line, then column 1, ... Each column touches only its own few
// adaptive models, so the model working set stays L1-resident instead of
// striding through the whole bank once per line — the line-major order
// is cache-miss bound when clusters*columns*contexts models exceed L2.
//
// data_t: column-major (columns x n_lines) symbols. recon_t (optional)
// is written column-major too. Returns payload bytes or -(needed).
// init_bank/out_bank (optional): model-bank snapshot blobs of
// qvz_tables_bank_words() u32 words — load the adaptive state before
// coding / capture it after (QVZ2 shard priming).
int64_t qvz_encode_fused_colmajor(void* tables, const uint8_t* data_t,
                                  uint64_t n_lines,
                                  const uint8_t* cluster_ids,
                                  const uint32_t* well_state,
                                  const double* dist, uint8_t* recon_t,
                                  double* distortion_out, uint8_t* out,
                                  int64_t cap, const uint32_t* init_bank,
                                  uint32_t* out_bank) {
  Tables* tb = static_cast<Tables*>(tables);
  uint32_t columns = tb->columns;
  ModelBank bank;
  bank.init(tb->model_card.data(), tb->n_models);
  if (init_bank) bank.load(init_bank);
  BitWriter bw(out, cap);
  Encoder enc(&bw);

  // Dither draws are defined in (line, column) order; materialize them
  // transposed so the per-column pass reads sequentially.
  std::vector<uint8_t> draws_t(static_cast<size_t>(n_lines) * columns);
  {
    std::vector<uint8_t> draws(static_cast<size_t>(n_lines) * columns);
    Well well(well_state);
    for (size_t i = 0; i < draws.size(); ++i) {
      draws[i] = static_cast<uint8_t>(well.draw7());
    }
    for (uint64_t i = 0; i < n_lines; ++i) {
      for (uint32_t c = 0; c < columns; ++c) {
        draws_t[static_cast<size_t>(c) * n_lines + i] =
            draws[i * columns + c];
      }
    }
  }

  // Cluster ids first (model 0 stays hot).
  for (uint64_t i = 0; i < n_lines; ++i) {
    uint32_t c = cluster_ids ? cluster_ids[i] : 0;
    enc.step(bank, 0, c);
    bank.update(0, c);
  }

  // Per-column two-pass split (mirror of the decoder's): quantization
  // depends only on the previous column's outputs, so it runs as a
  // branch-light vector pass; the serial coder loop then streams the
  // precomputed (model, symbol) pairs with models prefetched ahead.
  std::vector<uint8_t> prev_qv(n_lines, 0);
  std::vector<uint32_t> mcol(n_lines);
  std::vector<uint8_t> xcol(n_lines);
  double total_d = 0.0;
  for (uint32_t col = 0; col < columns; ++col) {
    const uint8_t* dcol = data_t + static_cast<size_t>(col) * n_lines;
    const uint8_t* drawcol = draws_t.data() + static_cast<size_t>(col) * n_lines;
    uint8_t* rcol = recon_t ? recon_t + static_cast<size_t>(col) * n_lines
                            : nullptr;
    for (uint64_t i = 0; i < n_lines; ++i) {
      uint32_t cl = cluster_ids ? cluster_ids[i] : 0;
      uint64_t cc = static_cast<uint64_t>(cl) * columns + col;
      int32_t ctx = tb->ctxmap[cc * A + prev_qv[i]];
      uint64_t p = tb->pair_base[cc] + static_cast<uint32_t>(ctx);
      uint32_t choice = drawcol[i] >= tb->qratio[p] ? 1u : 0u;
      uint64_t pc = p * 2 + choice;
      uint8_t d = dcol[i];
      uint8_t qv = tb->qv_map[pc * A + d];
      mcol[i] = static_cast<uint32_t>(1 + pc);
      xcol[i] = tb->qs_map[pc * A + d];
      if (dist) total_d += dist[static_cast<uint32_t>(d) * A + qv];
      if (rcol) rcol[i] = qv;
      prev_qv[i] = qv;
    }
    for (uint64_t i = 0; i < n_lines; ++i) {
      if (i + 4 < n_lines) bank.prefetch(mcol[i + 4]);
      enc.step(bank, mcol[i], xcol[i]);
      bank.update(mcol[i], xcol[i]);
    }
  }
  if (distortion_out) *distortion_out = total_d / columns;
  if (out_bank) bank.dump(out_bank);
  int64_t n = enc.finish();
  if (bw.overflow) return -n;
  return n;
}

// Column-major quantization ONLY (the front half of
// qvz_encode_fused_colmajor, no coder state touched): context chain +
// WELL dither + table maps, writing (cols, n) model-id and symbol
// buffers for a later qvz_encode_precomputed_colmajor pass. Lets the
// primed pipeline quantize EVERY shard in parallel while only the
// warmup shard's coding is serial, and is also faster than the fused
// pass split-wise (the coder loop then runs 1.6x faster without the
// interleaved lookups).
void qvz_quantize_colmajor(void* tables, const uint8_t* data_t,
                           uint64_t n_lines, const uint8_t* cluster_ids,
                           const uint32_t* well_state, const double* dist,
                           uint8_t* recon_t, double* distortion_out,
                           uint32_t* model_t, uint8_t* qs_t) {
  Tables* tb = static_cast<Tables*>(tables);
  uint32_t columns = tb->columns;
  std::vector<uint8_t> draws_t(static_cast<size_t>(n_lines) * columns);
  {
    std::vector<uint8_t> draws(static_cast<size_t>(n_lines) * columns);
    Well well(well_state);
    for (size_t i = 0; i < draws.size(); ++i) {
      draws[i] = static_cast<uint8_t>(well.draw7());
    }
    for (uint64_t i = 0; i < n_lines; ++i) {
      for (uint32_t c = 0; c < columns; ++c) {
        draws_t[static_cast<size_t>(c) * n_lines + i] =
            draws[i * columns + c];
      }
    }
  }
  std::vector<uint8_t> prev_qv(n_lines, 0);
  double total_d = 0.0;
  for (uint32_t col = 0; col < columns; ++col) {
    const uint8_t* dcol = data_t + static_cast<size_t>(col) * n_lines;
    const uint8_t* drawcol =
        draws_t.data() + static_cast<size_t>(col) * n_lines;
    uint8_t* rcol = recon_t ? recon_t + static_cast<size_t>(col) * n_lines
                            : nullptr;
    uint32_t* mcol = model_t + static_cast<size_t>(col) * n_lines;
    uint8_t* xcol = qs_t + static_cast<size_t>(col) * n_lines;
    for (uint64_t i = 0; i < n_lines; ++i) {
      uint32_t cl = cluster_ids ? cluster_ids[i] : 0;
      uint64_t cc = static_cast<uint64_t>(cl) * columns + col;
      int32_t ctx = tb->ctxmap[cc * A + prev_qv[i]];
      uint64_t p = tb->pair_base[cc] + static_cast<uint32_t>(ctx);
      uint32_t choice = drawcol[i] >= tb->qratio[p] ? 1u : 0u;
      uint64_t pc = p * 2 + choice;
      uint8_t d = dcol[i];
      uint8_t qv = tb->qv_map[pc * A + d];
      mcol[i] = static_cast<uint32_t>(1 + pc);
      xcol[i] = tb->qs_map[pc * A + d];
      if (dist) total_d += dist[static_cast<uint32_t>(d) * A + qv];
      if (rcol) rcol[i] = qv;
      prev_qv[i] = qv;
    }
  }
  if (distortion_out) *distortion_out = total_d / columns;
}

// Column-major entropy coding from PRECOMPUTED per-symbol (model id,
// symbol index) streams — the back half of the device-quantization
// production path: the accelerator runs the batched quantize+dither scan
// (ops/quantize.py; reference semantics qv_compressor.c:86-118) and the
// host coder only advances the adaptive arithmetic stream. Emits a
// payload byte-identical to qvz_encode_fused_colmajor for the same
// decisions (same model/symbol sequence => same bits).
int64_t qvz_encode_precomputed_colmajor(void* tables,
                                        const uint32_t* model_t,  // (cols,n)
                                        const uint8_t* qs_t,      // (cols,n)
                                        const uint8_t* cluster_ids,
                                        uint64_t n_lines, uint8_t* out,
                                        int64_t cap,
                                        const uint32_t* init_bank,
                                        uint32_t* out_bank) {
  Tables* tb = static_cast<Tables*>(tables);
  uint32_t columns = tb->columns;
  ModelBank bank;
  bank.init(tb->model_card.data(), tb->n_models);
  if (init_bank) bank.load(init_bank);
  BitWriter bw(out, cap);
  Encoder enc(&bw);

  for (uint64_t i = 0; i < n_lines; ++i) {
    uint32_t c = cluster_ids ? cluster_ids[i] : 0;
    enc.step(bank, 0, c);
    bank.update(0, c);
  }
  for (uint32_t col = 0; col < columns; ++col) {
    const uint32_t* mcol = model_t + static_cast<size_t>(col) * n_lines;
    const uint8_t* xcol = qs_t + static_cast<size_t>(col) * n_lines;
    for (uint64_t i = 0; i < n_lines; ++i) {
      uint32_t m = mcol[i];
      uint32_t x = xcol[i];
      enc.step(bank, m, x);
      bank.update(m, x);
    }
  }
  if (out_bank) bank.dump(out_bank);
  int64_t n = enc.finish();
  if (bw.overflow) return -n;
  return n;
}

// Model-bank state after a precomputed (model, symbol) stream, WITHOUT
// coding it: bank.update is independent of the arithmetic interval, so
// the primed-bank snapshot the device lanes need is derivable from the
// warmup shard's quantize outputs alone. This breaks the serial
// dependency "code warmup -> bank -> code lanes": the warmup's actual
// coding (the payload bytes) can then run in a host thread CONCURRENTLY
// with the device lanes. Order matches qvz_encode_precomputed_colmajor
// exactly (cluster segment first, then columns).
void qvz_bank_from_stream(void* tables, const uint32_t* model_t,
                          const uint8_t* qs_t, const uint8_t* cluster_ids,
                          uint64_t n_lines, uint32_t* out_bank) {
  Tables* tb = static_cast<Tables*>(tables);
  uint32_t columns = tb->columns;
  ModelBank bank;
  bank.init(tb->model_card.data(), tb->n_models);
  for (uint64_t i = 0; i < n_lines; ++i) {
    bank.update(0, cluster_ids ? cluster_ids[i] : 0);
  }
  for (uint32_t col = 0; col < columns; ++col) {
    const uint32_t* mcol = model_t + static_cast<size_t>(col) * n_lines;
    const uint8_t* xcol = qs_t + static_cast<size_t>(col) * n_lines;
    for (uint64_t i = 0; i < n_lines; ++i) {
      bank.update(mcol[i], xcol[i]);
    }
  }
  bank.dump(out_bank);
}

// Exact single-model replay (see qvz_rt.h): the device coder's pass-1
// triple computation assumes no mid-shard rescale (exactly checked,
// rare for column models at device shard sizes) — but the cluster-id
// model sees one update per LINE and does rescale; its triples are
// replayed here at memory speed and shipped to the device instead.
// Reference semantics: cum scan arith.c:40-43, update qv_stream.c:9-25.
void qvz_replay_model(const uint32_t* init_counts, uint32_t card,
                      uint32_t init_total, const uint8_t* syms,
                      uint64_t n, uint32_t* out_triples) {
  std::vector<uint32_t> c(init_counts, init_counts + card);
  uint32_t total = init_total;
  for (uint64_t i = 0; i < n; ++i) {
    uint32_t x = syms[i];
    uint32_t cum = 0;
    for (uint32_t k = 0; k < x; ++k) cum += c[k];
    out_triples[i * 3] = cum;
    out_triples[i * 3 + 1] = cum + c[x];
    out_triples[i * 3 + 2] = total;
    c[x] += kStep;
    uint32_t nn = total + kStep;
    if (nn > kArithR) {
      nn = 0;
      for (uint32_t k = 0; k < card; ++k) {
        if (c[k]) {
          c[k] = (c[k] >> 1) + 1;
          nn += c[k];
        }
      }
    }
    total = nn;
  }
}

// ---- v1-decode serial-floor experiment (ROADMAP item 1 closure) ----
// The v1 stream is ONE interleaved adaptive stream; its decode loop is
// a serial chain: tag -> symbol scan -> interval update -> renorm ->
// new tag bits -> next step. These two functions measure the floor of
// that chain with the model machinery (scan + count lookup + adaptive
// update) made FREE: first record every step's coder inputs (cum_lo,
// cum_hi, total, magic) by replaying the encoder's decisions, then
// time a pure interval+renorm+tag replay against the real payload
// bits. If even that replay cannot reach the speed target, no amount
// of model-side optimization can.

void qvz_record_triples_linemajor(void* tables, const uint32_t* model_t,
                                  const uint8_t* qs_t,
                                  const uint8_t* cluster_ids,
                                  uint64_t n_lines, uint32_t* out5) {
  Tables* tb = static_cast<Tables*>(tables);
  uint32_t columns = tb->columns;
  ModelBank bank;
  bank.init(tb->model_card.data(), tb->n_models);
  uint64_t w = 0;
  auto rec = [&](uint32_t m, uint32_t x) {
    const ModelBank::MInfo& mi = bank.info[m];
    const uint32_t* c = bank.counts.data() + mi.off;
    uint32_t cum = 0;
    for (uint32_t k = 0; k < x; ++k) cum += c[k];
    out5[w * 5] = cum;
    out5[w * 5 + 1] = cum + c[x];
    out5[w * 5 + 2] = mi.total;
    out5[w * 5 + 3] = static_cast<uint32_t>(mi.magic);
    out5[w * 5 + 4] = static_cast<uint32_t>(mi.magic >> 32);
    ++w;
    bank.update(m, x);
  };
  for (uint64_t i = 0; i < n_lines; ++i) {
    rec(0, cluster_ids ? cluster_ids[i] : 0);
    for (uint32_t col = 0; col < columns; ++col) {
      rec(model_t[static_cast<size_t>(col) * n_lines + i],
          qs_t[static_cast<size_t>(col) * n_lines + i]);
    }
  }
}

double qvz_interval_floor_v1(const uint8_t* payload, uint64_t payload_len,
                             const uint32_t* rec5, uint64_t n_steps,
                             uint32_t* out_check) {
  BitReader br(payload, payload_len);
  uint32_t l = 0, u = kFull, t = br.get_bits(kArithM);
  uint32_t check = 0;
  struct timespec t0, t1;
  clock_gettime(CLOCK_MONOTONIC, &t0);
  // all but the final symbol take the full renormalizing step; the
  // final one is the reference's drain (no renorm, arith.c:190-205)
  for (uint64_t i = 0; i + 1 < n_steps; ++i) {
    uint32_t cum_lo = rec5[i * 5];
    uint32_t cum_hi = rec5[i * 5 + 1];
    uint32_t n = rec5[i * 5 + 2];
    uint64_t M = rec5[i * 5 + 3] |
                 (static_cast<uint64_t>(rec5[i * 5 + 4]) << 32);
    uint64_t range = static_cast<uint64_t>(u) - l + 1;
    uint32_t hi_b = (cum_hi == n ? static_cast<uint32_t>(range)
                                 : mulh_div(range * cum_hi, M));
    uint32_t lo_b = (cum_lo == 0 ? 0u : mulh_div(range * cum_lo, M));
    u = l + hi_b - 1;
    l = l + lo_b;
    uint32_t diff = l ^ u;
    int k1 = (diff >> kMsbShift) == 0
                 ? __builtin_clz(diff << (32 - kArithM)) : 0;
    l = (l << k1) & kFull;
    u = ((u << k1) | ((1u << k1) - 1u)) & kFull;
    t = ((t << k1) | br.getk(k1)) & kFull;
    bool e3 = (l >> kSmsbShift) == 0x01 && (u >> kSmsbShift) == 0x02;
    uint32_t lx = l << (32 - kSmsbShift);
    uint32_t ux = u << (32 - kSmsbShift);
    int lrun = __builtin_clz(~lx | 1u);
    int zrun = ux ? __builtin_clz(ux) : 32;
    int k3 = e3 ? 1 + (lrun < zrun ? lrun : zrun) : 0;
    uint32_t flip = e3 ? kMsbBit : 0u;
    uint32_t lmask = e3 ? kMsbClear : kFull;
    l = (l << k3) & lmask;
    u = (((u << k3) & lmask) | (e3 ? kMsbBit : 0u)) | ((1u << k3) - 1u);
    t = (((t << k3) | br.getk(k3)) & kFull) ^ flip;
    check ^= t;
  }
  clock_gettime(CLOCK_MONOTONIC, &t1);
  *out_check = check ^ l ^ u;
  return (t1.tv_sec - t0.tv_sec) + 1e-9 * (t1.tv_nsec - t0.tv_nsec);
}

// Column-major decode matching qvz_encode_fused_colmajor. Writes
// Phred+33 text lines with newlines into out ((columns+1) per line).
// draws_t_in (optional): precomputed column-major dither draws — lets
// the caller overlap draw generation with the serial warmup-decode
// stage of a primed container.
int32_t qvz_decode_colmajor(void* tables, const uint8_t* payload,
                            uint64_t payload_len, uint64_t n_lines,
                            const uint32_t* well_state, uint8_t* out,
                            const uint32_t* init_bank, uint32_t* out_bank,
                            uint8_t* cluster_out,
                            const uint8_t* draws_t_in) {
  Tables* tb = static_cast<Tables*>(tables);
  uint32_t columns = tb->columns;
  ModelBank bank;
  bank.init(tb->model_card.data(), tb->n_models);
  if (init_bank) bank.load(init_bank);
  BitReader br(payload, payload_len);
  Decoder dec(&br);

  std::vector<uint8_t> draws_t_own;
  const uint8_t* draws_tp;
  if (draws_t_in) {
    draws_tp = draws_t_in;
  } else {
    draws_t_own.resize(static_cast<size_t>(n_lines) * columns);
    std::vector<uint8_t> draws(static_cast<size_t>(n_lines) * columns);
    Well well(well_state);
    for (size_t i = 0; i < draws.size(); ++i) {
      draws[i] = static_cast<uint8_t>(well.draw7());
    }
    for (uint64_t i = 0; i < n_lines; ++i) {
      for (uint32_t c = 0; c < columns; ++c) {
        draws_t_own[static_cast<size_t>(c) * n_lines + i] =
            draws[i * columns + c];
      }
    }
    draws_tp = draws_t_own.data();
  }

  std::vector<uint8_t> cl(n_lines, 0);
  for (uint64_t i = 0; i < n_lines; ++i) {
    uint32_t c = dec.step(bank, 0);
    bank.update(0, c);
    if (dec.bad) return -3;
    if (c >= tb->n_clusters) return -1;
    cl[i] = static_cast<uint8_t>(c);
  }
  if (cluster_out) std::memcpy(cluster_out, cl.data(), n_lines);

  // Column-major structural advantage: every symbol's model depends
  // only on the PREVIOUS column's decoded values, all known before the
  // column starts. The model-id resolution (context lookup + dither
  // compare) therefore runs as a branch-light vector pass per column,
  // and the serial coder loop does nothing but step/update with models
  // prefetched several symbols ahead — the line-major decoder cannot
  // do this (its next model depends on the symbol just decoded).
  std::vector<uint8_t> prev_qv(n_lines, 0);
  std::vector<uint32_t> mcol(n_lines);
  for (uint32_t col = 0; col < columns; ++col) {
    const uint8_t* drawcol = draws_tp + static_cast<size_t>(col) * n_lines;
    bool last_col = (col + 1 == columns);
    for (uint64_t i = 0; i < n_lines; ++i) {
      uint64_t cc = static_cast<uint64_t>(cl[i]) * columns + col;
      int32_t ctx = tb->ctxmap[cc * A + prev_qv[i]];
      if (ctx < 0) return -2;
      uint64_t p = tb->pair_base[cc] + static_cast<uint32_t>(ctx);
      uint32_t choice = drawcol[i] >= tb->qratio[p] ? 1u : 0u;
      mcol[i] = static_cast<uint32_t>(1 + p * 2 + choice);
    }
    if (br.overrun()) return -4;
    for (uint64_t i = 0; i < n_lines; ++i) {
      if (i + 4 < n_lines) bank.prefetch(mcol[i + 4]);
      uint32_t m = mcol[i];
      uint32_t x;
      if (last_col && i + 1 == n_lines) {
        x = dec.last(bank, m);
        // The reference's decoder_last_step never updates the model
        // (qv_compressor.c:222-225); when a priming snapshot is being
        // captured, apply the bookkeeping update anyway so the decoder
        // snapshot matches the encoder's (which updates every symbol).
        if (out_bank) bank.update(m, x);
      } else {
        x = dec.step(bank, m);
        bank.update(m, x);
        if (dec.bad) return -3;
      }
      uint8_t qv = tb->model_syms[tb->model_off[m] + x];
      out[i * (columns + 1) + col] = static_cast<uint8_t>(qv + 33);
      prev_qv[i] = qv;
    }
  }
  for (uint64_t i = 0; i < n_lines; ++i) {
    out[i * (columns + 1) + columns] = '\n';
  }
  if (out_bank) bank.dump(out_bank);
  return 0;
}

// Cluster-segment prologue for the DEVICE lane decoder: decodes the
// n_lines cluster ids that open a column-major shard (model 0 — the
// one model the device replay cannot carry, since it legitimately
// rescales at one update per line) and exports the exact coder state
// where the device scan takes over: state_out = {l, u, t, consumed
// bits}. Model 0 is never touched again in column-major order
// (qvz_decode_colmajor decodes it only in this prefix), so the device
// pass needs no model-0 counts.
int32_t qvz_decode_cluster_prologue(void* tables, const uint8_t* payload,
                                    uint64_t payload_len, uint64_t n_lines,
                                    const uint32_t* init_bank,
                                    uint8_t* cluster_out,
                                    uint64_t* state_out) {
  Tables* tb = static_cast<Tables*>(tables);
  ModelBank bank;
  bank.init(tb->model_card.data(), tb->n_models);
  if (init_bank) bank.load(init_bank);
  BitReader br(payload, payload_len);
  Decoder dec(&br);
  for (uint64_t i = 0; i < n_lines; ++i) {
    uint32_t c = dec.step(bank, 0);
    bank.update(0, c);
    if (dec.bad) return -3;
    if (c >= tb->n_clusters) return -1;
    cluster_out[i] = static_cast<uint8_t>(c);
  }
  state_out[0] = dec.l;
  state_out[1] = dec.u;
  state_out[2] = dec.t;
  state_out[3] = br.next * 8 - static_cast<uint64_t>(br.navail);
  return 0;
}

// --- full decode -----------------------------------------------------------

// Decodes the payload into Phred+33 text lines with trailing newlines.
// Returns 0 on success.
int32_t qvz_decode_lines(void* tables, const uint8_t* payload,
                         uint64_t payload_len, uint64_t n_lines,
                         const uint32_t* well_state, uint8_t* out,
                         uint8_t* cluster_out, int32_t verbose) {
  Tables* tb = static_cast<Tables*>(tables);
  uint32_t columns = tb->columns;
  ModelBank bank;
  bank.init(tb->model_card.data(), tb->n_models);
  BitReader br(payload, payload_len);
  Decoder dec(&br);
  Well well(well_state);

  for (uint64_t i = 0; i < n_lines; ++i) {
    // Reference prints at lineCtr 0, 1M, ...; the special-cased final
    // line ALSO prints when (lines-1) % 1e6 == 0 (qv_compressor.c:196-198
    // repeats the in-loop print before the last line), so no last-line
    // suppression here (the old `i + 1 < n_lines` guard
    // diverged at n_lines == k*1e6 + 1).
    if (verbose && i % 1000000 == 0) {
      printf("Line: %dM\n", static_cast<int>(i / 1000000));
    }
    bool last_line = (i + 1 == n_lines);
    uint32_t c = dec.step(bank, 0);
    bank.update(0, c);
    if (dec.bad) return -3;
    if (c >= tb->n_clusters) return -1;
    if (br.overrun()) return -4;
    if (cluster_out) cluster_out[i] = static_cast<uint8_t>(c);
    uint8_t* orow = out + i * (columns + 1);
    uint64_t cbase = static_cast<uint64_t>(c) * columns;
    // Model id for column 0 (context is always 0 there).
    {
      int32_t ctx0 = tb->ctxmap[cbase * A];
      if (ctx0 < 0) return -2;
      uint64_t p0 = tb->pair_base[cbase] + static_cast<uint32_t>(ctx0);
      uint32_t ch0 = well.draw7() >= tb->qratio[p0] ? 1u : 0u;
      uint32_t m = 1 + 2 * static_cast<uint32_t>(p0) + ch0;
      for (uint32_t col = 0; col < columns; ++col) {
        uint32_t x;
        bool final_sym = last_line && col + 1 == columns;
        x = final_sym ? dec.last(bank, m) : dec.step(bank, m);
        if (dec.bad) return -3;
        uint8_t qv = tb->model_syms[tb->model_off[m] + x];
        orow[col] = static_cast<uint8_t>(qv + 33);
        uint32_t m_next = 0;
        if (col + 1 < columns) {
          // Resolve the NEXT symbol's model from the freshly decoded
          // context and pull its header+counts toward L1 while the
          // current model update retires — the decode chain is serial,
          // so this is free latency overlap.
          uint64_t cc = cbase + col + 1;
          int32_t ctx = tb->ctxmap[cc * A + qv];
          if (ctx < 0) return -2;
          uint64_t p = tb->pair_base[cc] + static_cast<uint32_t>(ctx);
          uint32_t choice = well.draw7() >= tb->qratio[p] ? 1u : 0u;
          m_next = 1 + 2 * static_cast<uint32_t>(p) + choice;
          bank.prefetch(m_next);
        }
        if (!final_sym) bank.update(m, x);
        m = m_next;
      }
    }
    orow[columns] = '\n';
  }
  return 0;
}

}  // extern "C"
