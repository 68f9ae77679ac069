// Native day-grid packer: long minute-bar rows -> dense [T, 240, 5] tensor.
//
// This is the host-side hot loop of the data plane (the role polars' Rust
// engine plays in the reference, SURVEY.md §2.1): one cache-friendly pass
// over the day's ~1.2M rows doing timestamp->slot conversion and a
// last-write-wins scatter, instead of five numpy fancy-indexing passes.
// The PyTorch port's copy of the JAX package's native/gridpack.cpp, byte
// for byte below this header (tests/test_torch_native.py holds the two
// libraries' outputs equal). Loaded from Python via ctypes
// (replication_of_minute_frequency_factor_tpu_torch/native/__init__.py);
// the numpy implementation in data/minute.py stays as the portable
// fallback and the parity oracle for this code.
//
// Build: at first use, by the loader, into build/native/
// (g++ -O3 -march=native -fno-math-errno -shared -fPIC)

#include <cmath>
#include <cstdint>

#if defined(__AVX512F__) && defined(__AVX512BW__) && \
    defined(__AVX512VL__)
#include <immintrin.h>
#endif

namespace {

constexpr int64_t kAmOpenMsm = 9 * 60 + 30;  // 570
constexpr int64_t kPmOpenMsm = 13 * 60;      // 780
constexpr int64_t kAmSlots = 120;
constexpr int64_t kPmSlots = 120;
constexpr int64_t kNSlots = 240;
constexpr int64_t kNFields = 5;

// HHMMSSmmm -> slot index, -1 off-grid (mirrors sessions.time_to_slot:
// whole minutes inside [09:30,11:30) U [13:00,15:00) only).
inline int64_t TimeToSlot(int64_t t) {
  if (t % 100000 != 0) return -1;  // sub-minute component
  const int64_t hm = t / 10000000 * 60 + (t % 10000000) / 100000;
  if (hm >= kAmOpenMsm && hm < kAmOpenMsm + kAmSlots) return hm - kAmOpenMsm;
  if (hm >= kPmOpenMsm && hm < kPmOpenMsm + kPmSlots)
    return hm - kPmOpenMsm + kAmSlots;
  return -1;
}

#if defined(__AVX512F__) && defined(__AVX512BW__) && \
    defined(__AVX512VL__)
// Index vectors for the 5x16 deinterleave transpose: each 80-float block
// (16 slots x 5 interleaved fields) lands in five zmm registers; four
// two-source permutes per field funnel the stride-5 lanes into one
// contiguous 16-lane output. permutex2var index space is the 32-element
// concat of its two sources, so the tables are just the global offsets.
struct DeintIdx {
  __m512i i01[5], i23[5], icomb[5], i4[5];
  DeintIdx() {
    alignas(64) int v01[16], v23[16], vc[16], v4[16];
    for (int f = 0; f < 5; ++f) {
      int n01 = 0, n23 = 0;
      for (int j = 0; j < 16; ++j) v01[j] = v23[j] = vc[j] = 0;
      for (int s = 0; s < 16; ++s) {
        const int p = 5 * s + f;
        if (p < 32)
          v01[n01++] = p;
        else if (p < 64)
          v23[n23++] = p - 32;
      }
      int n = 0;
      for (int j = 0; j < n01; ++j) vc[n++] = j;
      for (int j = 0; j < n23; ++j) vc[n++] = 16 + j;
      for (int j = 0; j < 16; ++j) v4[j] = j;
      for (int s = 0; s < 16; ++s) {
        const int p = 5 * s + f;
        if (p >= 64) v4[s] = 16 + (p - 64);
      }
      i01[f] = _mm512_load_si512(v01);
      i23[f] = _mm512_load_si512(v23);
      icomb[f] = _mm512_load_si512(vc);
      i4[f] = _mm512_load_si512(v4);
    }
  }
};
const DeintIdx kDeint;
#endif

}  // namespace

extern "C" {

// Scatter n_rows long-format rows onto the dense grid.
//   tidx:   [n_rows] ticker index per row, -1 = unknown code (dropped)
//   time:   [n_rows] HHMMSSmmm
//   o/h/l/c/v: [n_rows] f64 field columns (parquet native width)
//   bars:   [n_tickers * 240 * 5] f32, caller-zeroed
//   mask:   [n_tickers * 240] u8, caller-zeroed
// Returns number of rows placed.
int64_t grid_pack(const int64_t* tidx, const int64_t* time,
                  const double* open, const double* high, const double* low,
                  const double* close, const double* volume, int64_t n_rows,
                  int64_t n_tickers, float* bars, uint8_t* mask) {
  int64_t placed = 0;
  for (int64_t i = 0; i < n_rows; ++i) {
    const int64_t t = tidx[i];
    if (t < 0 || t >= n_tickers) continue;
    const int64_t s = TimeToSlot(time[i]);
    if (s < 0) continue;
    float* cell = bars + (t * kNSlots + s) * kNFields;
    cell[0] = static_cast<float>(open[i]);
    cell[1] = static_cast<float>(high[i]);
    cell[2] = static_cast<float>(low[i]);
    cell[3] = static_cast<float>(close[i]);
    cell[4] = static_cast<float>(volume[i]);
    mask[t * kNSlots + s] = 1;
    ++placed;
  }
  return placed;
}

// Pack a dense [n_tickers, 240, 5] f32 grid into the compact wire format
// (data/wire.py), writing the FINAL narrow dtypes in one pass. The caller
// requests a format per field (its widen-only floor) and the encoder
// aborts with violation flags when the data does not fit, so the common
// case is a single pass that writes ~3 bytes/bar with no host-side
// re-narrowing; widenings are rare (bounded per run) retries.
//
// Modes — dclose: 0 = int4-pair pack (two deltas/byte, |d| <= 7),
//                 1 = int8, 2 = int16.
//         ohl:    0 = 1-byte tight pack (int4 open-close delta | 2-bit
//                     high/low wick offsets), 1 = 2-byte wick pack (int8
//                     delta + nibble wicks), 2 = int8 x3, 3 = int16 x3.
//         vol:    0 = 10-bit packed shares (4 values / 5 bytes, <= 1023),
//                 1 = 10-bit packed board lots (shares/100),
//                 2 = uint16 shares, 3 = uint16 lots, 4 = int32 shares.
// Two passes per ticker, both L1-resident: a branch-light
// tick-conversion/validation sweep the compiler can keep in vector
// registers (rint inlines to a rounding instruction; llround would be a
// libm call per field), then the sequential previous-close scan. Rounding
// mode (nearest-even vs half-away) cannot change accept/reject semantics:
// any value ~0.5 ticks off-grid already fails the 1e-3 alignment check.
//   bars [n*240*5] f32, mask [n*240] u8  ->
//   base [n] f32, dclose/dohl/volume in the requested formats
//   (caller-zeroing not required; every lane is written on success)
// Returns 0 on success; -1 if the batch is unrepresentable in ANY format
// (off-tick price, >int16 delta, fractional/negative/overflowing volume)
// — caller ships raw f32; 1 when a requested narrow mode overflowed —
// viol[0..2] name the fields (dclose/ohl/vol), outputs are partial
// garbage, caller widens those modes and retries.
int64_t wire_encode(const float* bars, const uint8_t* mask, int64_t n_tickers,
                    double inv_tick, int64_t dclose_mode, int64_t ohl_mode,
                    int64_t vol_mode, float* base, void* dclose_out,
                    void* dohl_out, void* volume_out, int64_t* viol) {
  // Tick-alignment tolerance: absolute 1e-3 ticks PLUS a relative term of
  // 4 f32 ulps. Prices arrive as f32, so a genuinely tick-aligned price
  // carries up to half an ulp of representation error — which, measured
  // in ticks, grows with magnitude and passes 1e-3 near 84 CNY at a 0.01
  // tick. An absolute-only tolerance would spuriously reject every
  // high-priced ticker (data/wire.py applies the same formula).
  const double kAlignTol = 1e-3;
  const double kRelTol = 2.4e-7;
  int8_t* dc8 = static_cast<int8_t*>(dclose_out);
  int16_t* dc16 = static_cast<int16_t*>(dclose_out);
  uint8_t* ohl_w = static_cast<uint8_t*>(dohl_out);
  int8_t* ohl8 = static_cast<int8_t*>(dohl_out);
  int16_t* ohl16 = static_cast<int16_t*>(dohl_out);
  uint16_t* v16 = static_cast<uint16_t*>(volume_out);
  int32_t* v32 = static_cast<int32_t*>(volume_out);
  viol[0] = viol[1] = viol[2] = 0;
  for (int64_t t = 0; t < n_tickers; ++t) {
    const float* tb = bars + t * kNSlots * kNFields;
    const uint8_t* tm = mask + t * kNSlots;

    // pass 1: prices -> integer ticks with masked-lane zeroing. Per-lane
    // validity folds into one flag via negated comparisons, so a NaN in any
    // field marks the lane bad (NaN fails every ordered comparison) rather
    // than resetting a running maximum; casts are blended to zero on bad
    // lanes to keep them defined.
    //
    // The interleaved [240, 5] layout defeats the auto-vectorizer
    // (stride-5 f32 loads have no vectype on gcc 12), so a deinterleave
    // into per-field buffers runs first — a permute-tree transpose on
    // AVX-512 builds (kDeint), a scalar copy elsewhere; the
    // double-precision convert/validate loop over the contiguous buffers
    // then auto-vectorizes (8 doubles/vector, lane_bad as a compare mask).
    alignas(64) float of[kNSlots], hf[kNSlots], lf[kNSlots], cf[kNSlots],
        vf[kNSlots];
    alignas(64) int32_t ot[kNSlots], ht[kNSlots], lt[kNSlots], ct[kNSlots],
        vt[kNSlots];
#if defined(__AVX512F__) && defined(__AVX512BW__) && \
    defined(__AVX512VL__)
    {
      float* outs[5] = {of, hf, lf, cf, vf};
      for (int64_t blk = 0; blk < kNSlots / 16; ++blk) {
        const float* src = tb + blk * 80;
        const __m512 z0 = _mm512_loadu_ps(src);
        const __m512 z1 = _mm512_loadu_ps(src + 16);
        const __m512 z2 = _mm512_loadu_ps(src + 32);
        const __m512 z3 = _mm512_loadu_ps(src + 48);
        const __m512 z4 = _mm512_loadu_ps(src + 64);
        // masked-out lanes zero HERE (not in the sweeps): the sweeps stay
        // single-type pure-float loops, and a NaN parked on a dead lane
        // can never flag the batch (numpy-oracle semantics)
        const __m128i mb = _mm_loadu_si128(
            reinterpret_cast<const __m128i*>(tm + blk * 16));
        const __mmask16 live = _mm_test_epi8_mask(mb, mb);
        for (int f = 0; f < 5; ++f) {
          const __m512 a01 = _mm512_permutex2var_ps(z0, kDeint.i01[f], z1);
          const __m512 a23 = _mm512_permutex2var_ps(z2, kDeint.i23[f], z3);
          __m512 r = _mm512_permutex2var_ps(a01, kDeint.icomb[f], a23);
          r = _mm512_permutex2var_ps(r, kDeint.i4[f], z4);
          _mm512_store_ps(outs[f] + blk * 16, _mm512_maskz_mov_ps(live, r));
        }
      }
    }
#else
    for (int64_t s = 0; s < kNSlots; ++s) {
      // masked lanes zero here so the sweeps are pure float loops (and a
      // NaN parked on a dead lane can never flag the batch)
      of[s] = tm[s] ? tb[s * kNFields + 0] : 0.0f;
      hf[s] = tm[s] ? tb[s * kNFields + 1] : 0.0f;
      lf[s] = tm[s] ? tb[s * kNFields + 2] : 0.0f;
      cf[s] = tm[s] ? tb[s * kNFields + 3] : 0.0f;
      vf[s] = tm[s] ? tb[s * kNFields + 4] : 0.0f;
    }
#endif
    // |o/h/l| ticks beyond 2^22+32767 guarantee an int16 delta overflow
    // (|d| >= |field| - |close| > 32767 given the close <= 2^22 bound), so
    // rejecting them here is equivalent to the pass-2 dmax check while
    // keeping every int32 cast below in range. Volume (< 2^31) fits int32.
    //
    // Masked-out lanes select to 0.0 (not a multiply by 0, which would
    // leak a NaN through), matching the numpy oracle: garbage on a masked
    // lane is zeroed, never a reason to reject the batch. Validity checks
    // are per-field negated comparisons so a NaN in ANY live field flags
    // its lane (a running max would wash the NaN out after one step).
    //
    // Fast sweep in f32 (16 lanes/vector): exact for the bound checks
    // (the bounds and every in-range rounded tick are f32-representable)
    // and for volume (float minus its nearest integer is exact). The one
    // inexact step is the price*inv_tick product, so the alignment test
    // carries a +/- margin of 2 f32 ulps: lanes inside
    // [tol - margin, tol + margin] are inconclusive and send the ticker
    // to the double-precision sweep. Aligned prices stay conclusive at
    // every magnitude below kBigF ticks (the relative tolerance grows in
    // step with the f32 error), so in practice the double sweep runs only
    // above ~20,000 CNY or on adversarial near-boundary values.
    const float itF = static_cast<float>(inv_tick);
    const float kTolF = 1e-3f;
    const float kRelF = 2.4e-7f;   // relative term: 4 f32 ulps
    const float kMargF = 1.2e-7f;  // 2 ulp of an f32 product
    const float kCMaxF = static_cast<float>(1LL << 22);
    const float kPMaxF = static_cast<float>((1LL << 22) + 32767);
    const float kVMaxF = static_cast<float>(1LL << 31);
    const float kVClampF = 2147483520.0f;  // largest f32 below 2^31
    const float kBigF = 2.0e6f;  // ticks beyond which f32 accept is vacuous
    int rej = 0, inc = 0;
    for (int64_t s = 0; s < kNSlots; ++s) {
      const float o = of[s] * itF, h = hf[s] * itF, l = lf[s] * itF,
                  c = cf[s] * itF, v = vf[s];
      const float ro = __builtin_rintf(o), rh = __builtin_rintf(h),
                  rl = __builtin_rintf(l), rc = __builtin_rintf(c),
                  rv = __builtin_rintf(v);
      const float eo = fabsf(o - ro), eh = fabsf(h - rh),
                  el = fabsf(l - rl), ec = fabsf(c - rc);
      const float go = fabsf(o) * kMargF, gh = fabsf(h) * kMargF,
                  gl = fabsf(l) * kMargF, gc = fabsf(c) * kMargF;
      // per-field tolerance = absolute + relative (see kRelTol above);
      // the +/- go margin brackets this sweep's own product rounding
      const float to = kTolF + kRelF * fabsf(ro),
                  th = kTolF + kRelF * fabsf(rh),
                  tl = kTolF + kRelF * fabsf(rl),
                  tc = kTolF + kRelF * fabsf(rc);
      rej |= !(eo <= to + go) | !(eh <= th + gh) |
             !(el <= tl + gl) | !(ec <= tc + gc) |
             !(fabsf(v - rv) <= kTolF) |
             !(fabsf(rc) <= kCMaxF) | !(fabsf(ro) <= kPMaxF) |
             !(fabsf(rh) <= kPMaxF) | !(fabsf(rl) <= kPMaxF) |
             !(v >= 0.0f) | !(rv < kVMaxF);
      // "within tolerance => same integer as the double path" needs
      // tol + margin < 0.5 tick; above kBigF ticks the band is vacuous
      // (and f32/f64 rint can differ by one), so those lanes are always
      // inconclusive and take the double sweep
      inc |= (eo > to - go) | (eh > th - gh) | (el > tl - gl) |
             (ec > tc - gc) |
             !(fabsf(ro) <= kBigF) | !(fabsf(rh) <= kBigF) |
             !(fabsf(rl) <= kBigF) | !(fabsf(rc) <= kBigF);
      // clamped casts keep out-of-range/NaN lanes defined (such lanes
      // always come with rej or inc set, so the values are never shipped).
      // Ternary clamps, not fminf/fmaxf: the libm pair's IEEE NaN
      // semantics block vectorization; the negated first compare sends a
      // NaN to the clamp floor instead of through the cast.
      const float co = !(ro > -kPMaxF) ? -kPMaxF : ro;
      const float ch = !(rh > -kPMaxF) ? -kPMaxF : rh;
      const float cl = !(rl > -kPMaxF) ? -kPMaxF : rl;
      const float cc = !(rc > -kPMaxF) ? -kPMaxF : rc;
      const float cv = !(rv > 0.0f) ? 0.0f : rv;
      ot[s] = static_cast<int32_t>(co > kPMaxF ? kPMaxF : co);
      ht[s] = static_cast<int32_t>(ch > kPMaxF ? kPMaxF : ch);
      lt[s] = static_cast<int32_t>(cl > kPMaxF ? kPMaxF : cl);
      ct[s] = static_cast<int32_t>(cc > kPMaxF ? kPMaxF : cc);
      vt[s] = static_cast<int32_t>(cv > kVClampF ? kVClampF : cv);
    }
    // inc outranks rej: every f32-only spurious rejection (tick
    // rounding at the kPMax/kCMax boundary above kBigF) also sets inc on
    // that lane, and the double sweep reproduces every genuine one
    if (inc) {
      // double-precision sweep: f32 couldn't separate the alignment
      // tolerance from its own product rounding at this magnitude
      const double kCMax = static_cast<double>(1LL << 22);
      const double kPMax = static_cast<double>((1LL << 22) + 32767);
      const double kVMax = static_cast<double>(1LL << 31);
      int bad = 0;
      for (int64_t s = 0; s < kNSlots; ++s) {
        const double o = of[s] * inv_tick, h = hf[s] * inv_tick,
                     l = lf[s] * inv_tick, c = cf[s] * inv_tick,
                     v = static_cast<double>(vf[s]);
        const double ro = __builtin_rint(o), rh = __builtin_rint(h),
                     rl = __builtin_rint(l), rc = __builtin_rint(c),
                     rv = __builtin_rint(v);
        const int lane_bad =
            !(fabs(o - ro) <= kAlignTol + kRelTol * fabs(ro)) |
            !(fabs(h - rh) <= kAlignTol + kRelTol * fabs(rh)) |
            !(fabs(l - rl) <= kAlignTol + kRelTol * fabs(rl)) |
            !(fabs(c - rc) <= kAlignTol + kRelTol * fabs(rc)) |
            !(fabs(v - rv) <= kAlignTol) |
            !(fabs(rc) <= kCMax) | !(fabs(ro) <= kPMax) |
            !(fabs(rh) <= kPMax) | !(fabs(rl) <= kPMax) |
            !(v >= 0.0) | !(rv < kVMax);  // raw v: -0.0004 must reject
            // (rv would round it to -0.0, which passes >= 0)
        bad |= lane_bad;
        ot[s] = lane_bad ? 0 : static_cast<int32_t>(ro);
        ht[s] = lane_bad ? 0 : static_cast<int32_t>(rh);
        lt[s] = lane_bad ? 0 : static_cast<int32_t>(rl);
        ct[s] = lane_bad ? 0 : static_cast<int32_t>(rc);
        vt[s] = lane_bad ? 0 : static_cast<int32_t>(rv);
      }
      if (bad) return -1;
    } else if (rej) {
      return -1;
    }

    // pass 2a: previous-valid-close scan — the one genuinely sequential
    // dependency, kept to ~4 scalar int ops per slot.
    alignas(64) int32_t dcv[kNSlots];
    {
      int32_t prev = 0;
      bool have_base = false;
      double base_val = 0.0;
      for (int64_t s = 0; s < kNSlots; ++s) {
        int32_t d = 0;
        if (tm[s]) {
          const int32_t c = ct[s];
          if (!have_base) {
            have_base = true;
            prev = c;
            base_val = c / inv_tick;
          }
          d = c - prev;
          prev = c;
        }
        dcv[s] = d;
      }
      base[t] = static_cast<float>(base_val);
    }

    // pass 2b: body/wick deltas + int16 range reduction, vectorized.
    // Masked lanes were zeroed in pass 1, so their deltas are zero with
    // no branch.
    alignas(64) int32_t dov[kNSlots], dhv[kNSlots], dlv[kNSlots];
    int32_t acmax = 0, amax = 0;
    for (int64_t s = 0; s < kNSlots; ++s) {
      const int32_t dop = ot[s] - ct[s], dh = ht[s] - ct[s],
                    dl = lt[s] - ct[s];
      dov[s] = dop;
      dhv[s] = dh;
      dlv[s] = dl;
      const int32_t ac = dcv[s] < 0 ? -dcv[s] : dcv[s];
      int32_t a = dop < 0 ? -dop : dop;
      const int32_t ah = dh < 0 ? -dh : dh, al = dl < 0 ? -dl : dl;
      a = a > ah ? a : ah;
      a = a > al ? a : al;
      acmax = acmax > ac ? acmax : ac;
      amax = amax > a ? amax : a;
    }
    if (acmax > 32767 || amax > 32767) return -1;

    // pass 2c: mode-directed narrow writes, one loop per mode so each
    // write loop vectorizes with no per-slot mode branch. Overflow flags
    // accumulate across the ticker and abort after it (outputs are
    // partial garbage on a widen-retry, same contract as before).
    const int64_t off = t * kNSlots;
    if (dclose_mode == 0) {
      // int4-pair pack: two two's-complement deltas per byte, even slot
      // in the low nibble.
      uint8_t* dc4 = static_cast<uint8_t*>(dclose_out) + t * (kNSlots / 2);
      int32_t v0 = 0;
      for (int64_t g = 0; g < kNSlots / 2; ++g) {
        const int32_t d0 = dcv[g * 2], d1 = dcv[g * 2 + 1];
        const int32_t a0 = d0 < 0 ? -d0 : d0, a1 = d1 < 0 ? -d1 : d1;
        v0 |= (a0 > 7) | (a1 > 7);
        dc4[g] = static_cast<uint8_t>((d0 & 0xF) | ((d1 & 0xF) << 4));
      }
      viol[0] |= v0;
    } else if (dclose_mode == 1) {
      int32_t v0 = 0;
      for (int64_t s = 0; s < kNSlots; ++s) {
        const int32_t d = dcv[s], a = d < 0 ? -d : d;
        v0 |= a > 127;
        dc8[off + s] = static_cast<int8_t>(d);
      }
      viol[0] |= v0;
    } else {
      for (int64_t s = 0; s < kNSlots; ++s)
        dc16[off + s] = static_cast<int16_t>(dcv[s]);
    }
    if (ohl_mode == 0) {
      // tight pack: int4 body delta | 2-bit wick offsets off the body,
      // one byte per bar.
      uint8_t* ohl_t = ohl_w + off;
      int32_t v1 = 0;
      for (int64_t s = 0; s < kNSlots; ++s) {
        const int32_t dop = dov[s];
        const int32_t h_off = dhv[s] - (dop > 0 ? dop : 0);
        const int32_t l_off = (dop < 0 ? dop : 0) - dlv[s];
        v1 |= (dop < -8) | (dop > 7) | (h_off < 0) | (h_off > 3) |
              (l_off < 0) | (l_off > 3);
        ohl_t[s] = static_cast<uint8_t>((dop & 0xF) | ((h_off & 3) << 4) |
                                        ((l_off & 3) << 6));
      }
      viol[1] |= v1;
    } else if (ohl_mode == 1) {
      // wick pack: int8 body delta + nibble wick offsets off the body.
      // Both bytes store as one little-endian uint16 (byte0 = body,
      // byte1 = wick nibbles) so the loop is a plain int32->uint16 pack.
      uint16_t* ohl_p = reinterpret_cast<uint16_t*>(ohl_w) + off;
      int32_t v1 = 0;
      for (int64_t s = 0; s < kNSlots; ++s) {
        const int32_t dop = dov[s];
        const int32_t h_off = dhv[s] - (dop > 0 ? dop : 0);
        const int32_t l_off = (dop < 0 ? dop : 0) - dlv[s];
        const int32_t ao = dop < 0 ? -dop : dop;
        v1 |= (ao > 127) | (h_off < 0) | (h_off > 15) | (l_off < 0) |
              (l_off > 15);
        ohl_p[s] = static_cast<uint16_t>(
            static_cast<uint8_t>(static_cast<int8_t>(dop)) |
            ((((h_off & 0xF) << 4) | (l_off & 0xF)) << 8));
      }
      viol[1] |= v1;
    } else if (ohl_mode == 2) {
      int32_t v1 = 0;
      for (int64_t s = 0; s < kNSlots; ++s) {
        const int32_t dop = dov[s], dh = dhv[s], dl = dlv[s];
        int32_t a = dop < 0 ? -dop : dop;
        const int32_t ah = dh < 0 ? -dh : dh, al = dl < 0 ? -dl : dl;
        a = a > ah ? a : ah;
        a = a > al ? a : al;
        v1 |= a > 127;
        ohl8[(off + s) * 3] = static_cast<int8_t>(dop);
        ohl8[(off + s) * 3 + 1] = static_cast<int8_t>(dh);
        ohl8[(off + s) * 3 + 2] = static_cast<int8_t>(dl);
      }
      viol[1] |= v1;
    } else {
      for (int64_t s = 0; s < kNSlots; ++s) {
        ohl16[(off + s) * 3] = static_cast<int16_t>(dov[s]);
        ohl16[(off + s) * 3 + 1] = static_cast<int16_t>(dhv[s]);
        ohl16[(off + s) * 3 + 2] = static_cast<int16_t>(dlv[s]);
      }
    }
    if (vol_mode <= 1) {
      // 10-bit pack, four values per 5 bytes (little-endian bit stream);
      // mode 1 packs board lots (shares/100) instead of shares.
      uint8_t* vp = static_cast<uint8_t*>(volume_out) + t * (kNSlots / 4 * 5);
      const int32_t div = vol_mode == 1 ? 100 : 1;
      int32_t v2 = 0;
      for (int64_t g = 0; g < kNSlots / 4; ++g) {
        int32_t q[4];
        for (int k = 0; k < 4; ++k) {
          const int32_t raw = vt[g * 4 + k];
          const int32_t u = raw / div;
          v2 |= (raw - u * div != 0) | (u > 1023);
          q[k] = u & 1023;
        }
        vp[g * 5 + 0] = static_cast<uint8_t>(q[0] & 0xFF);
        vp[g * 5 + 1] =
            static_cast<uint8_t>((q[0] >> 8) | ((q[1] & 0x3F) << 2));
        vp[g * 5 + 2] =
            static_cast<uint8_t>((q[1] >> 6) | ((q[2] & 0xF) << 4));
        vp[g * 5 + 3] =
            static_cast<uint8_t>((q[2] >> 4) | ((q[3] & 0x3) << 6));
        vp[g * 5 + 4] = static_cast<uint8_t>(q[3] >> 2);
      }
      viol[2] |= v2;
    } else if (vol_mode == 2) {
      int32_t v2 = 0;
      for (int64_t s = 0; s < kNSlots; ++s) {
        v2 |= vt[s] > 0xFFFF;
        v16[off + s] = static_cast<uint16_t>(vt[s]);
      }
      viol[2] |= v2;
    } else if (vol_mode == 3) {
      int32_t v2 = 0;
      for (int64_t s = 0; s < kNSlots; ++s) {
        const int32_t q = vt[s] / 100;
        v2 |= (vt[s] - q * 100 != 0) | (q > 0xFFFF);
        v16[off + s] = static_cast<uint16_t>(q);
      }
      viol[2] |= v2;
    } else {
      for (int64_t s = 0; s < kNSlots; ++s)
        v32[off + s] = vt[s];
    }
    if (viol[0] | viol[1] | viol[2]) return 1;  // caller widens + retries
  }
  return 0;
}

// Exported so Python can assert ABI compatibility at load time.
int64_t grid_pack_abi_version() { return 11; }

}  // extern "C"
