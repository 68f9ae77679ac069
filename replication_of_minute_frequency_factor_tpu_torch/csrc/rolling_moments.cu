// Rolling-window second moments for the mmt_ols_* factor family, written by
// hand for Hopper (sm_90a) and bound to PyTorch through a plain C interface
// (ops/rolling_cuda.py loads it with ctypes).
//
// Replaces the TPU kernel replication_of_minute_frequency_factor_tpu/ops/
// rolling_pallas.py::second_moments (body _moment_kernel). For every row r and
// slot m of the flattened [rows, L] inputs, with d_j = xc[m-j] - mu_x[m] and
// e_j = yc[m-j] - mu_y[m] over j < W, where xc/yc left of slot 0 count as 0:
//   s_xx[m] = sum_j d_j^2,   s_yy[m] = sum_j e_j^2,   s_xy[m] = sum_j d_j e_j.
// Each output takes its W terms in the order j = 0, 1, ..., W-1, as d = x - mu
// rounded and then fmaf: no TF32, no atomics, no dependence on block order.
//
// Two kernels compute it, bitwise equal on every lane:
//
// * The tiled kernel (second_moments_tiled_kernel), for W = 50, the window of
//   the main path (models/context.py rolling50). Two things bound it on this
//   card, nearly equally. Bytes: four f32 [rows, L] planes read and three
//   written, 268.8 MB at 40000 x 240, 0.080 ms at 3.35 TB/s. FP32 issue: 2
//   FSUB and 3 FFMA per term, 40000 x 240 x 50 x 5 = 2.4 G lane-instructions,
//   0.072 ms at 132 SMs x 128 lanes x 1.98 GHz. The design answers each:
//   - issue: the window is a template constant, so the term loop unrolls
//     into register names. One thread owns K = 4 consecutive slots of one
//     row and keeps 3K sums in registers; it reads each xc/yc value of its
//     span (K + W - 1 slots, widened to 16-byte chunks) once from shared
//     memory, with 16-byte loads, and walks the span from its highest slot
//     down so that every output still takes its terms in the order
//     j = 0, 1, .... That is 2(K+52)/K = 28 values read from shared memory
//     per output, in 16-byte loads, instead of 2W = 100 single-float loads,
//     and no loop, index or division arithmetic between the
//     FP32 instructions: the compiled kernel holds one tile's 1000 FP32
//     instructions among ~1400 in all, set-up and group loop included
//     (rolling_variants.py prints the census).
//   - bytes: persistent blocks (a multiple of the SM count) walk groups of
//     rows. While group g computes, all four input planes of group g+1 are
//     in flight into a second shared-memory stage by cp.async, so every
//     read overlaps compute within the block and not only across blocks.
//     The outputs are written from registers, vectorised and coalesced.
//     Every input element is read from device memory once and every output
//     written once.
//   Rows sit in shared memory at a pitch of L rounded up to 16 bytes, so
//   every row starts 16-byte aligned and the 16-byte reads work at every L.
//   At L = 390 or 150 a row is not a multiple of 16 bytes, so those rows are
//   staged with 8-byte copies; outputs are written with the widest vector
//   that divides L. The zero left of slot 0 is a predicate on a thread's own
//   loads, not a padded copy. Thread-to-(row, slot) mapping and the group
//   size are fixed at launch: no integer division by a runtime value runs
//   per element.
//
// * The rowwise kernel (second_moments_rowwise_kernel) computes any other
//   window, and is the baseline the tiled one is timed and checked against.
//   A block stages 4 rows of xc and yc behind a W-1 zero left pad in shared
//   memory and one thread sums one output's W terms. The first version of
//   the port had only this kernel and said it was bound by memory traffic.
//   It was not: at 40000 x 240 on an H100 SXM (700 W) it runs at 0.22 ms,
//   36% of the byte bound, held back by instruction issue. Each of its
//   outputs loads 2W = 100 values from shared memory (0.96 G lane-loads a
//   call, ~0.12 ms of the one warp-wide load an SM serves per clock), the
//   runtime window keeps the loop and its address arithmetic, staging
//   divides by a runtime row length per element, and a block's copy and
//   compute do not overlap.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr size_t kDefaultSharedBytes = 48 * 1024;

// ---------------------------------------------------------------------------
// rowwise kernel: any window
// ---------------------------------------------------------------------------

constexpr int kRowsPerBlock = 4;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
second_moments_rowwise_kernel(const float* __restrict__ xc,
                              const float* __restrict__ yc,
                              const float* __restrict__ mu_x,
                              const float* __restrict__ mu_y,
                              float* __restrict__ s_xx,
                              float* __restrict__ s_yy,
                              float* __restrict__ s_xy,
                              int64_t rows, int L, int window) {
  extern __shared__ float smem[];
  const int P = L + window - 1;  // padded row length in shared memory
  float* xs = smem;
  float* ys = smem + kRowsPerBlock * P;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock;
  const int nr = rows - row0 < kRowsPerBlock
                     ? static_cast<int>(rows - row0) : kRowsPerBlock;

  // stage: xs[r * P + i] = xc[row0 + r, i - (W - 1)], zero left of slot 0
  for (int t = threadIdx.x; t < nr * P; t += blockDim.x) {
    const int r = t / P;
    const int m = t - r * P - (window - 1);
    float xv = 0.f;
    float yv = 0.f;
    if (m >= 0) {
      const int64_t g = (row0 + r) * L + m;
      xv = xc[g];
      yv = yc[g];
    }
    xs[t] = xv;
    ys[t] = yv;
  }
  __syncthreads();

  for (int t = threadIdx.x; t < nr * L; t += blockDim.x) {
    const int r = t / L;
    const int m = t - r * L;
    const int64_t g = (row0 + r) * L + m;
    const float mx = mu_x[g];
    const float my = mu_y[g];
    // xw[-j] = xc[m - j]
    const float* xw = xs + r * P + m + window - 1;
    const float* yw = ys + r * P + m + window - 1;
    float sxx = 0.f;
    float syy = 0.f;
    float sxy = 0.f;
    for (int j = 0; j < window; ++j) {
      const float d = xw[-j] - mx;
      const float e = yw[-j] - my;
      sxx = fmaf(d, d, sxx);
      syy = fmaf(e, e, syy);
      sxy = fmaf(d, e, sxy);
    }
    s_xx[g] = sxx;
    s_yy[g] = syy;
    s_xy[g] = sxy;
  }
}

// ---------------------------------------------------------------------------
// tiled kernel: W = 50, register-blocked sliding window, cp.async staging
// ---------------------------------------------------------------------------

constexpr int kTiledWindow = 50;   // the only window the tiled kernel takes
constexpr int kSlots = 4;          // K: consecutive output slots per thread
constexpr int kTiledThreads = 128;
constexpr int kTiledMinBlocks = 6;  // per SM: caps registers at 85
constexpr int kPlanes = 4;         // staged planes: xc, yc, mu_x, mu_y
// groups are sized so that both stages stay under this (three or more
// blocks to an SM), unless one row alone is larger
constexpr int kGroupSharedCap = 75 * 1024;
// the most dynamic shared memory one block may have (227 KB)
constexpr int kMaxBlockShared = 232448;

// slots of a tile's span left of its first output, rounded up to a 16-byte
// chunk: a span of kLeadSlots + K floats starts 16-byte aligned
template <int W>
constexpr int kLeadSlots = (W - 1 + 3) / 4 * 4;

struct TiledArgs {
  const float* xc;
  const float* yc;
  const float* mu_x;
  const float* mu_y;
  float* s_xx;
  float* s_yy;
  float* s_xy;
  int64_t rows;
  int64_t groups;  // ceil(rows / group)
  int L;
  int pitch;       // shared-memory row pitch in floats, a multiple of 4 and K
  int group;       // rows per group
  int tiles;       // K-slot tiles per row: ceil(L / K)
  int item_dr;     // a thread's next tile is blockDim tiles on:
  int item_dt;     //   (row, tile) += (item_dr, item_dt), tile wrapping
  int chunks;      // V-float copy chunks per row: L / V
  int copy_dr;     // a thread's next copy chunk, likewise
  int copy_dc;
};

// cp.async of one V-float chunk from device to shared memory
template <int V>
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (V == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(s), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
                 :: "r"(s), "l"(src), "n"(V * 4) : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most one committed group of this thread is still in flight
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

template <int V>
__device__ __forceinline__ void store_vec(float* dst, const float* src) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(src[0], src[1], src[2],
                                                  src[3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(dst) = make_float2(src[0], src[1]);
  } else {
    dst[0] = src[0];
  }
}

// Issues this thread's cp.async copies of rows [row0, row0 + nr) of the four
// input planes into one stage (plane p at dst + p * plane). The thread's
// first chunk is (row r, chunk c); its next is blockDim chunks on.
template <int V>
__device__ __forceinline__ void stage_rows(const TiledArgs& a, float* dst,
                                           int plane, int64_t row0, int nr,
                                           int r, int c) {
  const int64_t g0 = row0 * a.L;
  while (r < nr) {
    const int64_t g = g0 + r * a.L + c * V;
    float* d = dst + r * a.pitch + c * V;
    cp_async<V>(d, a.xc + g);
    cp_async<V>(d + plane, a.yc + g);
    cp_async<V>(d + 2 * plane, a.mu_x + g);
    cp_async<V>(d + 3 * plane, a.mu_y + g);
    r += a.copy_dr;
    c += a.copy_dc;
    if (c >= a.chunks) {
      c -= a.chunks;
      ++r;
    }
  }
}

// Adds the W terms of outputs m0 .. m0+K-1 to s_xx/s_yy/s_xy (registers).
// xr/yr is the row's staged xc/yc; mx/my the outputs' window means. Span
// index i holds slot m0 - lead + i, which output k takes as term
// j = lead + k - i: walking i downwards gives each output j = 0, 1, ....
template <int W, int K>
__device__ __forceinline__ void accumulate_span(const float* xr,
                                                const float* yr, int m0,
                                                const float* mx,
                                                const float* my, float* sxx,
                                                float* syy, float* sxy) {
  constexpr int kLead = kLeadSlots<W>;
  constexpr int kChunks = (kLead + K) / 4;  // 16-byte chunks of the span
  const int s0 = m0 - kLead;
#pragma unroll
  for (int q = kChunks - 1; q >= 0; --q) {
    float4 xq = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 yq = xq;
    if (s0 + 4 * q >= 0) {  // chunks left of slot 0 read as zeros
      xq = *reinterpret_cast<const float4*>(xr + s0 + 4 * q);
      yq = *reinterpret_cast<const float4*>(yr + s0 + 4 * q);
    }
    const float xv[4] = {xq.x, xq.y, xq.z, xq.w};
    const float yv[4] = {yq.x, yq.y, yq.z, yq.w};
#pragma unroll
    for (int u = 3; u >= 0; --u) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int j = kLead + k - (4 * q + u);  // a constant once unrolled
        if (j >= 0 && j < W) {
          const float d = xv[u] - mx[k];
          const float e = yv[u] - my[k];
          sxx[k] = fmaf(d, d, sxx[k]);
          syy[k] = fmaf(e, e, syy[k]);
          sxy[k] = fmaf(d, e, sxy[k]);
        }
      }
    }
  }
}

// The K outputs of slots [m0, m0 + K) of one row: the row in one stage at
// st (plane p at st + p * plane), its device-memory offset g0.
template <int W, int K, int V>
__device__ __forceinline__ void moments_tile(const TiledArgs& a,
                                             const float* st, int plane,
                                             int64_t g0, int m0) {
  float mx[K];
  float my[K];
#pragma unroll
  for (int v = 0; v < K; v += 4) {
    const float4 p = *reinterpret_cast<const float4*>(st + 2 * plane + m0 + v);
    const float4 q = *reinterpret_cast<const float4*>(st + 3 * plane + m0 + v);
    mx[v] = p.x; mx[v + 1] = p.y; mx[v + 2] = p.z; mx[v + 3] = p.w;
    my[v] = q.x; my[v + 1] = q.y; my[v + 2] = q.z; my[v + 3] = q.w;
  }
  float sxx[K];
  float syy[K];
  float sxy[K];
#pragma unroll
  for (int k = 0; k < K; ++k) sxx[k] = syy[k] = sxy[k] = 0.f;
  accumulate_span<W, K>(st, st + plane, m0, mx, my, sxx, syy, sxy);
  // slots at or past L hold stale shared memory and are not stored
  const int64_t g = g0 + m0;
#pragma unroll
  for (int v = 0; v < K; v += V) {
    if (m0 + v < a.L) {
      store_vec<V>(a.s_xx + g + v, sxx + v);
      store_vec<V>(a.s_yy + g + v, syy + v);
      store_vec<V>(a.s_xy + g + v, sxy + v);
    }
  }
}

template <int W, int K, int V>
__global__ void __launch_bounds__(kTiledThreads, kTiledMinBlocks)
second_moments_tiled_kernel(const TiledArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int plane = a.group * a.pitch;  // floats of one plane of one stage
  const int tid = threadIdx.x;
  // fixed for the whole launch: this thread's first tile and first copy
  // chunk of every group (the kernel's only divisions, once per thread)
  const int item_r = tid / a.tiles;
  const int item_t = tid - item_r * a.tiles;
  const int copy_r = tid / a.chunks;
  const int copy_c = tid - copy_r * a.chunks;
  auto rows_in = [&](int64_t gi) {
    const int64_t left = a.rows - gi * a.group;
    return left < a.group ? static_cast<int>(left) : a.group;
  };

  int64_t grp = blockIdx.x;
  stage_rows<V>(a, smem, plane, grp * a.group, rows_in(grp), copy_r, copy_c);
  cp_async_commit();
  int s = 0;
  for (; grp < a.groups; grp += gridDim.x) {
    const int64_t next = grp + gridDim.x;
    if (next < a.groups) {
      stage_rows<V>(a, smem + kPlanes * (s ^ 1) * plane, plane,
                    next * a.group, rows_in(next), copy_r, copy_c);
    }
    cp_async_commit();    // possibly empty: one group per iteration
    cp_async_wait_one();  // this thread's copies of group grp have landed
    __syncthreads();      // and everyone else's

    const int64_t row0 = grp * a.group;
    const int nr = rows_in(grp);
    const float* st = smem + kPlanes * s * plane;
    int r = item_r;
    int t = item_t;
    while (r < nr) {
      moments_tile<W, K, V>(a, st + r * a.pitch, plane, (row0 + r) * a.L,
                            t * K);
      r += a.item_dr;
      t += a.item_dt;
      if (t >= a.tiles) {
        t -= a.tiles;
        ++r;
      }
    }
    __syncthreads();  // stage s is free for the copy issued next iteration
    s ^= 1;
  }
}

template <int W, int K, int V>
int launch_tiled(TiledArgs a, cudaStream_t stream) {
  const auto kernel = second_moments_tiled_kernel<W, K, V>;
  constexpr int kAlign = K > 4 ? K : 4;
  a.pitch = (a.L + kAlign - 1) / kAlign * kAlign;
  a.tiles = (a.L + K - 1) / K;
  a.chunks = a.L / V;
  a.item_dr = kTiledThreads / a.tiles;
  a.item_dt = kTiledThreads % a.tiles;
  a.copy_dr = kTiledThreads / a.chunks;
  a.copy_dc = kTiledThreads % a.chunks;
  // bytes of one row in both stages
  const size_t row_bytes = 2ull * kPlanes * a.pitch * sizeof(float);
  if (row_bytes > static_cast<size_t>(kMaxBlockShared)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }

  int dev = 0;
  int sms = 0;
  int sm_shared = 0;
  int reserved = 0;
  int by_regs = 0;  // blocks per SM as registers and threads allow
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        &sm_shared, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        &reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &by_regs, kernel, kTiledThreads, 0);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (by_regs < 1) return static_cast<int>(cudaErrorInvalidConfiguration);

  // Rows per group, fixed here for the whole launch: the fewest thread
  // passes on the busiest SM, counting the blocks it holds, the rounds of
  // groups each block walks and the passes of blockDim tiles per group.
  int64_t max_group = kGroupSharedCap / static_cast<int64_t>(row_bytes);
  if (max_group < 1) max_group = 1;
  if (max_group > a.rows) max_group = a.rows;
  int64_t best_cost = -1;
  int best_group = 1;
  int best_grid = 1;
  for (int gsz = 1; gsz <= max_group; ++gsz) {
    int per_sm = static_cast<int>(sm_shared / (gsz * row_bytes + reserved));
    if (per_sm > by_regs) per_sm = by_regs;
    if (per_sm < 1) continue;
    const int64_t groups = (a.rows + gsz - 1) / gsz;
    const int64_t slots = static_cast<int64_t>(per_sm) * sms;
    const int64_t grid = groups < slots ? groups : slots;
    const int64_t rounds = (groups + grid - 1) / grid;
    const int64_t passes =
        (static_cast<int64_t>(gsz) * a.tiles + kTiledThreads - 1) /
        kTiledThreads;
    const int64_t cost = (grid + sms - 1) / sms * rounds * passes;
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      best_group = gsz;
      best_grid = static_cast<int>(grid);
    }
  }
  a.group = best_group;
  a.groups = (a.rows + best_group - 1) / best_group;
  const size_t smem = best_group * row_bytes;
  if (smem > kDefaultSharedBytes) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<best_grid, kTiledThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Both entries launch on `stream` over contiguous f32 [rows, L] planes and
// return cudaGetLastError() as an int (0 on success). They allocate nothing
// and do not synchronise.

// The rowwise kernel, any window >= 1.
extern "C" int rolling_second_moments_rowwise(const void* xc, const void* yc,
                                              const void* mu_x,
                                              const void* mu_y, void* s_xx,
                                              void* s_yy, void* s_xy,
                                              long long rows, int L,
                                              int window, void* stream) {
  if (rows <= 0 || L <= 0) return 0;
  if (window < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      2ull * kRowsPerBlock * static_cast<size_t>(L + window - 1) * sizeof(float);
  if (smem > kDefaultSharedBytes) {
    const cudaError_t err = cudaFuncSetAttribute(
        second_moments_rowwise_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  second_moments_rowwise_kernel<<<static_cast<unsigned int>(blocks), kThreads,
                                  smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xc), static_cast<const float*>(yc),
      static_cast<const float*>(mu_x), static_cast<const float*>(mu_y),
      static_cast<float*>(s_xx), static_cast<float*>(s_yy),
      static_cast<float*>(s_xy), static_cast<int64_t>(rows), L, window);
  return static_cast<int>(cudaGetLastError());
}

// The tiled kernel: window must be 50 and every pointer 16-byte aligned;
// a row of L slots must fit one block's shared memory twice (L <= 7264).
extern "C" int rolling_second_moments_tiled(const void* xc, const void* yc,
                                            const void* mu_x,
                                            const void* mu_y, void* s_xx,
                                            void* s_yy, void* s_xy,
                                            long long rows, int L, int window,
                                            void* stream) {
  if (rows <= 0 || L <= 0) return 0;
  if (window != kTiledWindow) return static_cast<int>(cudaErrorInvalidValue);
  const void* ptrs[] = {xc, yc, mu_x, mu_y, s_xx, s_yy, s_xy};
  for (const void* p : ptrs) {
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) {
      return static_cast<int>(cudaErrorMisalignedAddress);
    }
  }
  TiledArgs a{};
  a.xc = static_cast<const float*>(xc);
  a.yc = static_cast<const float*>(yc);
  a.mu_x = static_cast<const float*>(mu_x);
  a.mu_y = static_cast<const float*>(mu_y);
  a.s_xx = static_cast<float*>(s_xx);
  a.s_yy = static_cast<float*>(s_yy);
  a.s_xy = static_cast<float*>(s_xy);
  a.rows = static_cast<int64_t>(rows);
  a.L = L;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // device memory is read and written in the widest vector dividing L
  if (L % 4 == 0) return launch_tiled<kTiledWindow, kSlots, 4>(a, s);
  if (L % 2 == 0) return launch_tiled<kTiledWindow, kSlots, 2>(a, s);
  return launch_tiled<kTiledWindow, kSlots, 1>(a, s);
}

extern "C" const char* rolling_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
