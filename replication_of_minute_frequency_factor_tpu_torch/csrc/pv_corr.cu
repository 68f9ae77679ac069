// The six price-volume correlations of the pv_corr family (models/pv_corr.py)
// in one pass over the day's bars, written by hand for Hopper (sm_90a) and
// bound to PyTorch through a plain C interface (ops/pv_corr_cuda.py loads it
// with ctypes).
//
// It replaces no TPU kernel: the JAX package computes the family in plain
// jnp, six compositions of shift_valid / pct_change_valid and masked_corr
// (ops/masked.py), each of which the port ran as ~55 ATen launches over whole
// [rows, L] fields. This kernel computes what those compositions compute,
// with the same f32 arithmetic, for every row r of the flattened
// bars [rows, L, 5] (open, high, low, close, volume) and mask [rows, L]:
//
//   corr_prv   corr(close pct-change, volume)        over present bars with a
//                                                    previous present bar
//   corr_prvr  corr(close pct-change, volume pct-change) over nonzero-volume
//                                                    present bars with a
//                                                    previous such bar
//   corr_pv    corr(close, volume)                   over present bars
//   corr_pvd   corr(close, volume of the previous present bar)
//   corr_pvl   corr(close, volume of the next present bar)
//   corr_pvr   corr(close, volume pct-change)        as corr_prvr's bars
//
// and writes out[6, rows] in that order. Each Pearson is the plain version's
// two-pass form: both series anchored at the first bar of the pair's mask
// (unless the caller passes anchor = 0, the constant_window pin's "noise"
// reading), the masked means, then the centred products' sums, and
// cov / sqrt(var_x * var_y); NaN where the pair has n <= 1 bars. Every
// pct-change is (x - prev) / prev. Lanes outside a pair's mask are selected
// away, never multiplied by 0, so NaN or inf there never enters a sum, while
// a NaN inside a valid lane propagates. Products are rounded before they are
// added (__fmul_rn: no FMA contraction), divisions and the square root are
// IEEE. Only the order of summation differs from the plain version.
//
// corr_pvl is summed over the same bars as corr_pvd: the pair (close of bar
// s, volume of the next present bar) is, re-indexed by that next bar, the
// pair (close of the previous present bar, volume of bar t) over the present
// bars t that have a previous present bar. The set of pairs, the count and
// the anchor pair (the first one) are the plain version's, so every lane
// needs only what lies before it.
//
// What bounds it on this card. Bytes set the least time: the work needs
// close, volume and the mask once, 9 bytes a bar (0.104 ms at the resident
// step's [160000, 240] at 3.35 TB/s), and the interleaved records make a
// kernel read all 20 bytes of each record and the mask, ~21 bytes a bar
// (0.24 ms). On an H100 SXM (700 W) it takes 0.71 ms there, so bytes do not
// hold it: by a count of this source it issues ~2300 warp instructions a row
// (three IEEE divisions a bar, ten masked series in two passes, 26 warp
// reductions), and instruction issue and latency are the likely bound. The
// design:
//   - one warp owns one (day, ticker) row and reads it once: a lane a slot,
//     its close, its volume and its mask byte, four 32-slot chunks' loads in
//     flight. A warp's close and volume loads of one chunk cover the same
//     640 contiguous bytes, so each sector comes from memory once. Close and
//     volume are staged in shared memory. The stage is sized at run time from
//     the slot count, and the rows a block holds are chosen on the first
//     launch at each slot count on each device (and kept) so that the stages
//     fit and the most warps stay resident: one design serves 240,
//     390 and 1440 slots with no knob. (Staging the records through shared
//     memory with contiguous 4-byte loads instead, picking close and volume
//     out there, took 28-50% longer on an H100: the picking costs more
//     instructions than the loads it saves.)
//   - 32-slot chunks, a lane a slot. Warp ballots of the mask and of
//     volume != 0 give each lane its previous present bar and its previous
//     present nonzero-volume bar, by a shuffle within the chunk and a carry
//     across chunks. The pct-changes and shifts are formed in registers and
//     kept in the stage for the two moment passes.
//   - the ten distinct (series, mask) sums of the means, then the sixteen
//     centred sums, each a lane's partial sum and one butterfly of shuffles.
// No atomics, no dependence on block order: the bits repeat run to run.

#include <cuda_runtime.h>

#include <cstdint>
#include <map>
#include <mutex>
#include <utility>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kFields = 5;
constexpr int kClose = 3;
constexpr int kVolume = 4;
constexpr int kPairs = 6;
constexpr int kSeries = 10;
constexpr int kMaxWarps = 8;
constexpr int kMaxBlockShared = 232448;  // 227 KB, sm_90's per-block cap

// the stage's float planes, each [pitch] (pitch: the slots rounded up to 32)
enum Plane {
  kC,    // close
  kV,    // volume
  kCp,   // close of the previous present bar
  kVp,   // volume of the previous present bar
  kPc,   // close pct-change over present bars
  kPcb,  // close pct-change over present nonzero-volume bars
  kPvb,  // volume pct-change over present nonzero-volume bars
  kPlanes
};
// the stage's bit planes, one 32-bit word a chunk
enum Word {
  kM,  // present
  kP,  // present, with a previous present bar
  kQ,  // present, nonzero volume, with a previous such bar
  kWords
};

struct Args {
  const float* bars;
  const uint8_t* mask;
  float* out;
  int64_t rows;
  int L;
  int chunks;
  int pitch;
  int anchor;
};

// one row's stage in shared memory
struct Stage {
  float* plane[kPlanes];
  unsigned* word[kWords];
};

// a lane's bar as the two passes read it: its planes and its mask bits
struct Bar {
  float c, v, cp, vp, pc, pcb, pvb;
  bool in[kWords];
};

__device__ __forceinline__ Bar read_bar(const Stage& st, int s, int k,
                                        int lane) {
  Bar b;
  b.c = st.plane[kC][s];
  b.v = st.plane[kV][s];
  b.cp = st.plane[kCp][s];
  b.vp = st.plane[kVp][s];
  b.pc = st.plane[kPc][s];
  b.pcb = st.plane[kPcb][s];
  b.pvb = st.plane[kPvb][s];
#pragma unroll
  for (int w = 0; w < kWords; ++w) b.in[w] = (st.word[w][k] >> lane) & 1u;
  return b;
}

// The ten distinct series the six correlations read, each over the bit
// plane series_word() names. Pair j is (x, y) = (kPairX[j], kPairY[j]).
__device__ __forceinline__ void series(const Bar& b, float x[kSeries]) {
  x[0] = b.pc;   // corr_prv x               over P
  x[1] = b.v;    // corr_prv y, corr_pvl y   over P
  x[2] = b.pcb;  // corr_prvr x              over Q
  x[3] = b.pvb;  // corr_prvr y, corr_pvr y  over Q
  x[4] = b.c;    // corr_pv x                over M
  x[5] = b.v;    // corr_pv y                over M
  x[6] = b.c;    // corr_pvd x               over P
  x[7] = b.vp;   // corr_pvd y               over P
  x[8] = b.cp;   // corr_pvl x               over P
  x[9] = b.c;    // corr_pvr x               over Q
}

__device__ __forceinline__ int series_word(int j) {
  return (j == 4 || j == 5) ? kM : (j == 2 || j == 3 || j == 9) ? kQ : kP;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

__device__ __forceinline__ int last_lane(unsigned bits) {
  return 31 - __clz(bits);
}

__global__ void __launch_bounds__(kMaxWarps * 32)
pv_corr_six_kernel(const Args a) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) +
                      warp;
  if (row >= a.rows) return;  // a whole warp; no block barrier follows

  Stage st;
  float* base = smem + static_cast<size_t>(warp) *
                           (kPlanes * a.pitch + kWords * a.chunks);
#pragma unroll
  for (int p = 0; p < kPlanes; ++p) st.plane[p] = base + p * a.pitch;
  unsigned* words = reinterpret_cast<unsigned*>(base + kPlanes * a.pitch);
#pragma unroll
  for (int w = 0; w < kWords; ++w) st.word[w] = words + w * a.chunks;

  // 1. stage: each lane's bar of every chunk, close and volume read out of
  // the row's records and the mask's ballot, four chunks' loads in flight
  // (a warp's loads of one chunk's closes and volumes cover the same 640
  // contiguous bytes, so every sector is fetched once)
  const float* rec = a.bars + row * a.L * kFields;
  const uint8_t* mrow = a.mask + row * a.L;
#pragma unroll 4
  for (int k = 0; k < a.chunks; ++k) {
    const int s = k * 32 + lane;
    float c = 0.f, v = 0.f;
    bool m = false;
    if (s < a.L) {
      c = __ldg(rec + s * kFields + kClose);
      v = __ldg(rec + s * kFields + kVolume);
      m = __ldg(mrow + s) != 0;
    }
    st.plane[kC][s] = c;
    st.plane[kV][s] = v;
    const unsigned bits = __ballot_sync(kFull, m);
    if (lane == 0) st.word[kM][k] = bits;
  }
  __syncwarp();

  // 2. derive: each lane's previous present bar and previous present
  // nonzero-volume bar (in its chunk by ballot and shuffle, else carried
  // from earlier chunks), the shifts and pct-changes, the pair masks
  const unsigned below = (1u << lane) - 1u;
  bool have_p = false, have_q = false;
  float last_c = 0.f, last_v = 0.f, last_qc = 0.f, last_qv = 0.f;
  int n[kWords] = {0, 0, 0};
  int first[kWords] = {-1, -1, -1};
  for (int k = 0; k < a.chunks; ++k) {
    const int s = k * 32 + lane;
    const float c = st.plane[kC][s];
    const float v = st.plane[kV][s];
    const unsigned M = st.word[kM][k];
    const bool m = (M >> lane) & 1u;
    const unsigned B = __ballot_sync(kFull, m && v != 0.f);

    const unsigned mb = M & below;
    const int src = mb ? last_lane(mb) : lane;
    float pc = __shfl_sync(kFull, c, src);
    float pv = __shfl_sync(kFull, v, src);
    if (!mb) {
      pc = last_c;
      pv = last_v;
    }
    const unsigned bb = B & below;
    const int srcb = bb ? last_lane(bb) : lane;
    float qc = __shfl_sync(kFull, c, srcb);
    float qv = __shfl_sync(kFull, v, srcb);
    if (!bb) {
      qc = last_qc;
      qv = last_qv;
    }
    const bool p = m && (mb || have_p);
    const bool q = ((B >> lane) & 1u) && (bb || have_q);
    st.plane[kCp][s] = pc;
    st.plane[kVp][s] = pv;
    st.plane[kPc][s] = __fdiv_rn(__fsub_rn(c, pc), pc);
    st.plane[kPcb][s] = __fdiv_rn(__fsub_rn(c, qc), qc);
    st.plane[kPvb][s] = __fdiv_rn(__fsub_rn(v, qv), qv);
    const unsigned P = __ballot_sync(kFull, p);
    const unsigned Q = __ballot_sync(kFull, q);
    if (lane == 0) {
      st.word[kP][k] = P;
      st.word[kQ][k] = Q;
    }
    const unsigned got[kWords] = {M, P, Q};
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      n[w] += __popc(got[w]);
      if (first[w] < 0 && got[w]) first[w] = k * 32 + __ffs(got[w]) - 1;
    }
    if (M) {
      const int t = last_lane(M);
      last_c = __shfl_sync(kFull, c, t);
      last_v = __shfl_sync(kFull, v, t);
      have_p = true;
    }
    if (B) {
      const int t = last_lane(B);
      last_qc = __shfl_sync(kFull, c, t);
      last_qv = __shfl_sync(kFull, v, t);
      have_q = true;
    }
  }
  __syncwarp();

  // 3. anchors: each series' value at the first bar of its mask (0 under
  // the "noise" reading, which subtracts nothing: x - 0 is x; 0 too for an
  // empty mask, whose pairs are NaN whatever the anchor)
  float x0[kSeries];
  {
    float at[kWords][kSeries];
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      const int f = first[w];
      if (f >= 0) {
        series(read_bar(st, f, f >> 5, f & 31), at[w]);
      } else {
#pragma unroll
        for (int j = 0; j < kSeries; ++j) at[w][j] = 0.f;
      }
    }
#pragma unroll
    for (int j = 0; j < kSeries; ++j) {
      x0[j] = a.anchor ? at[series_word(j)][j] : 0.f;
    }
  }

  // 4. the masked means of the anchored series
  float mean[kSeries];
#pragma unroll
  for (int j = 0; j < kSeries; ++j) mean[j] = 0.f;
  for (int k = 0; k < a.chunks; ++k) {
    const Bar b = read_bar(st, k * 32 + lane, k, lane);
    float x[kSeries];
    series(b, x);
#pragma unroll
    for (int j = 0; j < kSeries; ++j) {
      const bool ok = b.in[series_word(j)];
      mean[j] = __fadd_rn(mean[j], ok ? __fsub_rn(x[j], x0[j]) : 0.f);
    }
  }
#pragma unroll
  for (int j = 0; j < kSeries; ++j) {
    const int nj = n[series_word(j)];
    mean[j] = nj > 0 ? __fdiv_rn(warp_sum(mean[j]), static_cast<float>(nj))
                     : __int_as_float(0x7fc00000);
  }

  // 5. the centred sums: each series' squares, each pair's products
  const int kPairX[kPairs] = {0, 2, 4, 6, 8, 9};
  const int kPairY[kPairs] = {1, 3, 5, 7, 1, 3};
  float sq[kSeries], xy[kPairs];
#pragma unroll
  for (int j = 0; j < kSeries; ++j) sq[j] = 0.f;
#pragma unroll
  for (int j = 0; j < kPairs; ++j) xy[j] = 0.f;
  for (int k = 0; k < a.chunks; ++k) {
    const Bar b = read_bar(st, k * 32 + lane, k, lane);
    float x[kSeries];
    series(b, x);
    float d[kSeries];
#pragma unroll
    for (int j = 0; j < kSeries; ++j) {
      d[j] = b.in[series_word(j)]
                 ? __fsub_rn(__fsub_rn(x[j], x0[j]), mean[j])
                 : 0.f;
      sq[j] = __fadd_rn(sq[j], __fmul_rn(d[j], d[j]));
    }
#pragma unroll
    for (int j = 0; j < kPairs; ++j) {
      xy[j] = __fadd_rn(xy[j], __fmul_rn(d[kPairX[j]], d[kPairY[j]]));
    }
  }
#pragma unroll
  for (int j = 0; j < kSeries; ++j) sq[j] = warp_sum(sq[j]);
#pragma unroll
  for (int j = 0; j < kPairs; ++j) xy[j] = warp_sum(xy[j]);

  // 6. r = cov / sqrt(var_x * var_y), NaN where the pair has n <= 1
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < kPairs; ++j) {
      const float r = __fdiv_rn(
          xy[j], __fsqrt_rn(__fmul_rn(sq[kPairX[j]], sq[kPairY[j]])));
      a.out[j * a.rows + row] =
          n[series_word(kPairX[j])] > 1 ? r : __int_as_float(0x7fc00000);
    }
  }
}

// Rows (warps) per block for rows of L slots on the current device: the count
// that keeps the most warps resident on an SM, given the stages' shared
// memory and the kernel's registers; the larger block on a tie. It depends
// only on the device and L, so it is worked out once per pair and kept
// (0 where it fails, with the error in *err).
int block_warps(int L, int per_warp, cudaError_t* err) {
  static std::mutex lock;
  static std::map<std::pair<int, int>, int> known;
  int device = 0;
  *err = cudaGetDevice(&device);
  if (*err != cudaSuccess) return 0;
  std::lock_guard<std::mutex> hold(lock);
  const auto key = std::make_pair(device, L);
  const auto it = known.find(key);
  if (it != known.end()) return it->second;

  const auto kernel = pv_corr_six_kernel;
  // the per-block cap is raised to the card's most, once per device: every
  // launch then asks for what its own L needs
  *err = cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kMaxBlockShared);
  if (*err != cudaSuccess) return 0;
  *err = cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
  if (*err != cudaSuccess) return 0;
  int most = per_warp > 0 ? kMaxBlockShared / per_warp : kMaxWarps;
  if (most > kMaxWarps) most = kMaxWarps;
  int best_warps = 0;
  int best_resident = 0;
  for (int w = 1; w <= most; ++w) {
    int blocks = 0;
    *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                         w * 32, w * per_warp);
    if (*err != cudaSuccess) return 0;
    if (blocks * w > 0 && blocks * w >= best_resident) {
      best_resident = blocks * w;
      best_warps = w;
    }
  }
  if (best_warps == 0) {
    *err = cudaErrorInvalidConfiguration;
    return 0;
  }
  known[key] = best_warps;
  return best_warps;
}

}  // namespace

// Launches on `stream` over contiguous bars [rows, L, 5] f32 and mask
// [rows, L] bool, writing out [6, rows] f32; anchor is 1 for the
// constant_window pin's "degenerate" reading, 0 for "noise". Returns
// cudaGetLastError() as an int (0 on success); allocates nothing and does
// not synchronise. A row's stage must fit one block's shared memory
// (L <= 8192); L = 0 gives NaN, as an empty mask does.
extern "C" int pv_corr_six(const void* bars, const void* mask, void* out,
                           long long rows, int L, int anchor, void* stream) {
  if (rows <= 0) return 0;
  if (L < 0) return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.bars = static_cast<const float*>(bars);
  a.mask = static_cast<const uint8_t*>(mask);
  a.out = static_cast<float*>(out);
  a.rows = static_cast<int64_t>(rows);
  a.L = L;
  a.chunks = (L + 31) / 32;
  a.pitch = a.chunks * 32;
  a.anchor = anchor ? 1 : 0;
  const int per_warp =
      (kPlanes * a.pitch + kWords * a.chunks) * static_cast<int>(sizeof(float));
  if (per_warp > kMaxBlockShared) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSuccess;
  const int warps = block_warps(L, per_warp, &err);
  if (warps == 0) return static_cast<int>(err);
  const long long grid = (rows + warps - 1) / warps;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  pv_corr_six_kernel<<<static_cast<unsigned int>(grid), warps * 32,
                       warps * per_warp, static_cast<cudaStream_t>(stream)>>>(
      a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pv_corr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
