// The volume order statistics of every (day, ticker) row (the four
// mmt_*VolumeRet compounds of models/momentum.py and the three
// doc_vol*_ratio share sums of models/chip.py) in one pass over the row,
// written by hand for Hopper (sm_90a) and bound to PyTorch through a plain C
// interface (kernels.py loads it with ctypes; ops/volume_select_cuda.py wraps
// it).
//
// It replaces no TPU kernel: the JAX package computes these factors in plain
// jnp (replication_of_minute_frequency_factor_tpu/ops/ranking.py: a lax.top_k
// of the total-order key, a gather and the masked product), which the port
// ran as ATen compositions (ops/ranking.py: topk_threshold behind each
// compound and topk_sum behind each share sum), a torch.topk, gathers, a
// mask.sum, clamps and whole-field selections and products a factor. For
// every row r of the flattened bars [rows, S, 5] (open, high, low, close,
// volume), mask [rows, S] and vol_sum [rows] this kernel computes, for each
// requested answer (a kind and a k):
//
//   1. the thresholds: the k-th largest (top) or smallest (bottom) volume
//      among the S lanes with the invalid ones at -inf (top) or +inf
//      (bottom), in IEEE totalOrder (ops/ranking._total_order_key), the
//      extreme when fewer than k lanes are valid, NaN without one: bitwise
//      topk_threshold on the CPU, every NaN one NaN (a NaN threshold selects
//      nothing, whatever its bits). On the card the plain bottom threshold
//      places a valid NaN volume otherwise: it negates the volumes, and the
//      card's negation of a NaN keeps its sign where the CPU's flips it;
//   2. the compounds: the product of close/open over mask & (volume >= thr)
//      (<= for the bottom), every tie at the threshold included, minus 1, NaN
//      for a row with no bar. close/open is the f32 IEEE division ctx.ratio_co
//      computed (__fdiv_rn: no fast math, no contraction); the product runs in
//      f64 in another order than torch.prod's and is rounded once, after the
//      subtraction, so it is held to the plain version and the f64 oracle at
//      the parity tolerances, not bit for bit;
//   3. the share sums: the k largest valid volume / vol_sum (the volume share,
//      the same IEEE division as ctx.vol_share, every NaN folded onto +NaN),
//      summed in f32 largest first and padded with +0 to k terms: bitwise
//      topk_sum(vol_share, mask, k). Where vol_sum > 0 the shares are taken
//      in the volume order: x -> RN(x / vol_sum) is then non-decreasing in
//      totalOrder (-0 stays below +0), no valid volume is NaN (it would make
//      the sum NaN) and an infinite one makes vol_sum +inf and its share the
//      NaN that sorts first either way, so the k largest shares are the
//      shares of the k largest volumes, in the same order. Elsewhere (a
//      zero-volume day, a NaN, zero or negative sum) the row sorts its share
//      keys a second time.
//
// What bounds it on this card. Bytes set the least time: volume, open and
// close f32 and the mask read once (13 bytes a bar), vol_sum read and the
// answers written once (4 + 4 bytes an answer a row), 0.150 ms a cn step of
// [160000, 240] at 3.35 TB/s (the interleaved bar records force ~21 bytes a
// bar, 0.24 ms). The work is a sort of each row: a bitonic
// network over the row padded to a power of two, n/2 * log n * (log n + 1) /
// 2 compare-exchanges (4608 at n = 256, ~700 warp instructions a row), most
// strides by shuffles, so instruction issue bounds it, not bytes. The design
// answers that by sorting 32-bit keys, not 64-bit ones with a slot payload:
// every answer is a value read at a sorted position, and each selection is a
// re-scan of the row in slot order against its threshold. One order serves
// every k at once. The keys are the totalOrder keys with each NaN folded onto
// the qNaN of its sign, which frees key 0 for the invalid lanes and the
// padding, below every real key; the invalid lanes' -inf (top) or +inf
// (bottom) are placed back by counting the valid lanes and the valid NaNs of
// each sign. The work decomposition follows the row length, a shape the code
// observes, as in csrc/chip_segments.cu: rows of up to 512 slots take one
// warp a row, K = n / 32 keys a lane in registers, the network's strides
// below K within a lane and the rest by shuffles; longer rows (up to
// kMaxSlots) take a block a row, 8 keys a thread, with the strides across
// warps exchanged through shared memory. The reductions are butterflies of
// shuffles and the warps' partials in warp order: the bits repeat run to run.
// The sort and the reductions are this file's own copies (the key type
// differs from chip_segments.cu's, and a library is rebuilt from its own
// source's hash only).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
// the longest row: crypto_1440's 1440 slots, padded to 2048
constexpr int kMaxSlots = 2048;
constexpr int kMaxAnswers = 8;
// rows a block on the one-warp path
constexpr int kWarpRows = 4;
// a bar's fields (data/minute.py: open, high, low, close, volume)
constexpr int kFields = 5;
constexpr int kOpen = 0;
constexpr int kClose = 3;
constexpr int kVolume = 4;
// the key of an invalid lane and of a padding position: below every value
constexpr uint32_t kEmpty = 0u;

// ops/volume_select_cuda.KINDS, in order
enum Kind {
  kTop = 0,
  kBottom = 1,
  kShareSum = 2,
  kTopThreshold = 3,
  kBottomThreshold = 4
};

struct Args {
  const float* bars;
  const uint8_t* mask;
  const float* vol_sum;
  float* out;
  int64_t rows;
  int S;
  int n_answers;
  int kind[kMaxAnswers];
  int k[kMaxAnswers];
};

// ops/ranking._total_order_key(v) + 2^31 as an unsigned integer, each NaN
// folded onto the qNaN of its sign first; never 0
__device__ __forceinline__ uint32_t key_of(float v) {
  int32_t i = __float_as_int(v);
  if (isnan(v)) i = i < 0 ? static_cast<int32_t>(0xffc00000u) : 0x7fc00000;
  return static_cast<uint32_t>(i ^ ((i >> 31) & 0x7fffffff)) ^ 0x80000000u;
}

// the value a key stands for
__device__ __forceinline__ float value_of(uint32_t key) {
  const int32_t i = static_cast<int32_t>(key ^ 0x80000000u);
  return __int_as_float(i ^ ((i >> 31) & 0x7fffffff));
}

// topk_sum's fold: every NaN onto +NaN
__device__ __forceinline__ float fold_nan(float x) {
  return isnan(x) ? __int_as_float(0x7fc00000) : x;
}

__device__ __forceinline__ float nan_f32() { return __int_as_float(0x7fc00000); }

// a key's place in the padded shared-memory row: one spare key after every
// K, so a warp's accesses to the K-th keys of 32 lanes hit distinct banks
template <int K>
__device__ __forceinline__ int pad(int i) {
  return i + i / K;
}

__host__ __device__ constexpr int log2i(int n) {
  return n <= 1 ? 0 : 1 + log2i(n / 2);
}

template <int W>
__device__ __forceinline__ void row_sync() {
  if (W == 1) {
    __syncwarp();
  } else {
    __syncthreads();
  }
}

// One stage of the network at stride J < K: both keys in this thread's
// registers, indexed by constants whether or not the stages unroll.
template <int K, int J>
__device__ __forceinline__ void in_registers(uint32_t (&key)[K], int t,
                                             int k) {
  if constexpr (J < K) {
#pragma unroll
    for (int r = 0; r < K; ++r) {
      if ((r & J) == 0) {
        const bool up = ((t * K + r) & k) == 0;
        const uint32_t lo = min(key[r], key[r | J]);
        const uint32_t hi = max(key[r], key[r | J]);
        key[r] = up ? lo : hi;
        key[r | J] = up ? hi : lo;
      }
    }
  }
}

// Bitonic sort, ascending, of the row's N = 32 * K * W keys, thread t
// holding sorted positions t*K .. t*K + K - 1 when it ends.
template <int K, int W>
__device__ __forceinline__ void bitonic_sort(uint32_t (&key)[K], int t,
                                             uint32_t* skeys) {
  constexpr int T = 32 * W;
  constexpr int N = K * T;
  constexpr int LOG_N = log2i(N);
#pragma unroll
  for (int lk = 1; lk <= LOG_N; ++lk) {
    const int k = 1 << lk;
#pragma unroll
    for (int lj = lk - 1; lj >= 0; --lj) {
      const int j = 1 << lj;
      if (j < K) {
        switch (lj) {
          case 0: in_registers<K, 1>(key, t, k); break;
          case 1: in_registers<K, 2>(key, t, k); break;
          case 2: in_registers<K, 4>(key, t, k); break;
          default: in_registers<K, 8>(key, t, k); break;
        }
      } else {
        const int m = j / K;  // the partner thread is t ^ m
        const bool take_min = ((t & m) == 0) == (((t * K) & k) == 0);
        if (j < 32 * K) {
#pragma unroll
          for (int r = 0; r < K; ++r) {
            const uint32_t o = __shfl_xor_sync(kFull, key[r], m);
            key[r] = take_min ? min(key[r], o) : max(key[r], o);
          }
        } else {
          // the partner is in another warp: through shared memory
#pragma unroll
          for (int r = 0; r < K; ++r) skeys[pad<K>(t * K + r)] = key[r];
          __syncthreads();
#pragma unroll
          for (int r = 0; r < K; ++r) {
            const uint32_t o = skeys[pad<K>((t ^ m) * K + r)];
            key[r] = take_min ? min(key[r], o) : max(key[r], o);
          }
          __syncthreads();
        }
      }
    }
  }
}

struct Add {
  template <typename V>
  __device__ V operator()(V a, V b) const { return a + b; }
};
struct Mul {
  __device__ double operator()(double a, double b) const {
    return __dmul_rn(a, b);
  }
};

// The row's reduction, the same bits in every thread: a butterfly of
// shuffles (commutative at each step), then the warps' partials in order.
template <int W, typename V, typename Op>
__device__ __forceinline__ V reduce(V x, Op op, double* scratch) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = op(x, __shfl_xor_sync(kFull, x, o));
  if (W == 1) return x;
  V* s = reinterpret_cast<V*>(scratch);
  const int t = threadIdx.x;
  if ((t & 31) == 0) s[t >> 5] = x;
  __syncthreads();
  V total = s[0];
  for (int w = 1; w < W; ++w) total = op(total, s[w]);
  __syncthreads();
  return total;
}

// shared memory a row takes: the padded sorted keys, then the reductions'
// scratch (a double a warp)
template <int K, int W>
__host__ __device__ constexpr int keys_bytes() {
  return ((32 * K * W + 32 * W) * 4 + 7) / 8 * 8;
}
template <int K, int W>
__host__ __device__ constexpr int row_bytes() {
  return keys_bytes<K, W>() + W * 8;
}

template <int K, int W>
__device__ __forceinline__ void store_sorted(const uint32_t (&key)[K], int t,
                                             uint32_t* skeys) {
#pragma unroll
  for (int r = 0; r < K; ++r) skeys[pad<K>(t * K + r)] = key[r];
  row_sync<W>();
}

template <int K, int W>
__global__ void __launch_bounds__(W == 1 ? 32 * kWarpRows : 32 * W)
volume_select_kernel(const Args a) {
  constexpr int T = 32 * W;
  constexpr int N = K * T;
  extern __shared__ __align__(16) unsigned char smem[];
  int t;
  int64_t row;
  unsigned char* base;
  if (W == 1) {
    t = threadIdx.x & 31;
    const int sub = threadIdx.x >> 5;
    row = static_cast<int64_t>(blockIdx.x) * kWarpRows + sub;
    base = smem + sub * row_bytes<K, W>();
  } else {
    t = threadIdx.x;
    row = blockIdx.x;
    base = smem;
  }
  uint32_t* skeys = reinterpret_cast<uint32_t*>(base);
  double* scratch = reinterpret_cast<double*>(base + keys_bytes<K, W>());
  // the answers' kinds and k in shared memory, so that the answer loops
  // index them at run time without a copy of the arguments in local memory
  __shared__ int spec[2 * kMaxAnswers];
  if (threadIdx.x == 0) {
#pragma unroll
    for (int q = 0; q < kMaxAnswers; ++q) {
      spec[q] = a.kind[q];
      spec[kMaxAnswers + q] = a.k[q];
    }
  }
  __syncthreads();
  if (row >= a.rows) return;  // a whole warp; no block barrier follows

  // 1. read the row coalesced (slot r*T + t in register r): each valid
  // lane's volume, its key and close/open; count the valid lanes and the
  // valid NaN volumes of each sign
  const int64_t off = row * a.S;
  uint32_t key[K];
  float vol[K], ratio[K];
  unsigned valid = 0;
  int n = 0, nans = 0;
#pragma unroll
  for (int r = 0; r < K; ++r) {
    const int s = r * T + t;
    key[r] = kEmpty;
    vol[r] = 0.f;
    ratio[r] = 1.f;
    if (s < a.S && __ldg(a.mask + off + s) != 0) {
      const float* bar = a.bars + (off + s) * kFields;
      const float v = __ldg(bar + kVolume);
      vol[r] = v;
      ratio[r] = __fdiv_rn(__ldg(bar + kClose), __ldg(bar + kOpen));
      key[r] = key_of(v);
      valid |= 1u << r;
      ++n;
      if (isnan(v)) nans += signbit(v) ? 1 : 1 << 16;
    }
  }
  n = reduce<W>(n, Add(), scratch);
  nans = reduce<W>(nans, Add(), scratch);
  const int neg_nans = nans & 0xffff, pos_nans = nans >> 16;
  const int invalid = a.S - n;

  // 2. sort the keys; the valid ones take the top n sorted positions
  bitonic_sort<K, W>(key, t, skeys);
  store_sorted<K, W>(key, t, skeys);

  // 3. thresholds and compounds. Descending over the S lanes with the
  // invalid ones at -inf: the valid keys down to -inf, the invalid lanes,
  // then the valid -NaNs; ascending with them at +inf likewise.
  const uint32_t neg_inf = key_of(__int_as_float(0xff800000));
  const uint32_t pos_inf = key_of(__int_as_float(0x7f800000));
  const uint32_t neg_nan = key_of(__int_as_float(0xffc00000));
  const uint32_t pos_nan = key_of(nan_f32());
  bool any_share = false;
#pragma unroll 1
  for (int q = 0; q < a.n_answers; ++q) {
    const int kind = spec[q];
    if (kind == kShareSum) {
      any_share = true;
      continue;
    }
    float res = nan_f32();
    if (n > 0) {
      const int j = min(n, min(spec[kMaxAnswers + q], a.S)) - 1;
      const bool top = kind == kTop || kind == kTopThreshold;
      uint32_t tk;
      if (top) {
        tk = j < n - neg_nans ? skeys[pad<K>(N - 1 - j)]
             : j < n - neg_nans + invalid ? neg_inf : neg_nan;
      } else {
        tk = j < n - pos_nans ? skeys[pad<K>(N - n + j)]
             : j < n - pos_nans + invalid ? pos_inf : pos_nan;
      }
      const float thr = value_of(tk);
      if (kind == kTopThreshold || kind == kBottomThreshold) {
        res = thr;
      } else {
        double p = 1.0;
#pragma unroll
        for (int r = 0; r < K; ++r) {
          const bool sel = (top ? vol[r] >= thr : vol[r] <= thr);
          if (((valid >> r) & 1u) && sel) {
            p = __dmul_rn(p, static_cast<double>(ratio[r]));
          }
        }
        p = reduce<W>(p, Mul(), scratch);
        res = __double2float_rn(__dsub_rn(p, 1.0));
      }
    }
    if (t == 0) a.out[q * a.rows + row] = res;
  }
  if (!any_share) return;

  // 4. share sums: the k largest shares, largest first
  const float total = __ldg(a.vol_sum + row);
  const bool by_volume = total > 0.f;
  if (n > 0 && !by_volume) {
    row_sync<W>();  // every read of the volume keys done
#pragma unroll
    for (int r = 0; r < K; ++r) {
      key[r] = ((valid >> r) & 1u)
                   ? key_of(fold_nan(__fdiv_rn(vol[r], total)))
                   : kEmpty;
    }
    bitonic_sort<K, W>(key, t, skeys);
    store_sorted<K, W>(key, t, skeys);
  }
#pragma unroll 1
  for (int q = 0; q < a.n_answers; ++q) {
    if (spec[q] != kShareSum) continue;
    float res = nan_f32();
    if (n > 0) {
      const int kk = min(spec[kMaxAnswers + q], a.S);
      const int m = min(n, kk);
      for (int i = 0; i < kk; ++i) {
        float term = 0.f;
        if (i < m) {
          term = value_of(skeys[pad<K>(N - 1 - i)]);
          if (by_volume) term = fold_nan(__fdiv_rn(term, total));
        }
        res = i == 0 ? term : __fadd_rn(res, term);
      }
    }
    if (t == 0) a.out[q * a.rows + row] = res;
  }
}

// Launches the instantiation for rows padded to N = 32 * K * W slots. Every
// instantiation takes at most 9.3 KB of shared memory a block, under the
// 48 KB a launch has without raising the kernel's cap.
template <int K, int W>
int launch(const Args& a, cudaStream_t stream) {
  const int rows_a_block = W == 1 ? kWarpRows : 1;
  const int bytes = row_bytes<K, W>() * rows_a_block;
  const long long grid = (a.rows + rows_a_block - 1) / rows_a_block;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  volume_select_kernel<K, W>
      <<<static_cast<unsigned int>(grid), 32 * W * rows_a_block, bytes,
         stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` over contiguous bars [rows, S, 5] f32, mask [rows, S]
// bool and vol_sum [rows] f32, writing out [n_answers, rows] f32. answers
// holds n_answers (kind, k) pairs in host memory (kinds as
// ops/volume_select_cuda.KINDS, k >= 1), read before the launch. Returns
// cudaGetLastError() as an int (0 on success); allocates nothing and does not
// synchronise. 1 <= S <= 2048, 1 <= n_answers <= 8.
extern "C" int volume_select(const void* bars, const void* mask,
                             const void* vol_sum, void* out, long long rows,
                             int S, const int* answers, int n_answers,
                             void* stream) {
  if (rows <= 0) return 0;
  if (S < 1 || S > kMaxSlots || n_answers < 1 || n_answers > kMaxAnswers ||
      answers == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{};
  a.bars = static_cast<const float*>(bars);
  a.mask = static_cast<const uint8_t*>(mask);
  a.vol_sum = static_cast<const float*>(vol_sum);
  a.out = static_cast<float*>(out);
  a.rows = static_cast<int64_t>(rows);
  a.S = S;
  a.n_answers = n_answers;
  for (int q = 0; q < n_answers; ++q) {
    a.kind[q] = answers[2 * q];
    a.k[q] = answers[2 * q + 1];
    if (a.kind[q] < kTop || a.kind[q] > kBottomThreshold || a.k[q] < 1) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const auto s = static_cast<cudaStream_t>(stream);
  int n = 128;
  while (n < S) n <<= 1;
  switch (n) {
    case 128: return launch<4, 1>(a, s);
    case 256: return launch<8, 1>(a, s);
    case 512: return launch<16, 1>(a, s);
    case 1024: return launch<8, 4>(a, s);
    default: return launch<8, 8>(a, s);
  }
}

// The name every library of the port exports (kernels.ERROR_STRING).
extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
