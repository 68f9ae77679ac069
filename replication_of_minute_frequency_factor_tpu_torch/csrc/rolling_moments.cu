// Rolling-window second moments for the mmt_ols_* factor family, written by
// hand for Hopper (sm_90a) and bound to PyTorch through a plain C interface
// (ops/rolling_cuda.py loads it with ctypes).
//
// Replaces the TPU kernel replication_of_minute_frequency_factor_tpu/ops/
// rolling_pallas.py::second_moments (body _moment_kernel). For every row r and
// slot m of the flattened [rows, L] inputs, with d_j = xc[m-j] - mu_x[m] and
// e_j = yc[m-j] - mu_y[m] over j < W, where xc/yc left of slot 0 count as 0:
//   s_xx[m] = sum_j d_j^2,   s_yy[m] = sum_j e_j^2,   s_xy[m] = sum_j d_j e_j.
//
// What bounds it on this card: memory traffic. A call reads four f32 [rows, L]
// planes and writes three, 7 * rows * L * 4 bytes (~269 MB at 8 days x 5000
// tickers x 240 slots), against ~8 * W flops per output slot: a few GFLOP,
// which the card's f32 rate clears in less time than the bytes take to move.
//
// What the design does about it: every input element is read from device
// memory once and every output written once, with consecutive threads on
// consecutive slots so that each access is coalesced. A block stages
// kRowsPerBlock rows of xc and yc, each behind a W-1 zero left pad, in shared
// memory (2 * (L + W - 1) * 4 bytes per row: 2.3 KB at L=240, 11.9 KB at
// L=1440), so the W-fold reuse of every element by overlapping windows reads
// shared memory, not device memory. The Pallas tiling (128 rows x L per block)
// does not carry over: two such f32 inputs exceed the 227 KB a Hopper block
// can hold at L=240 already. One thread owns one (row, slot) output and
// accumulates its W terms in f32 FMAs in the TPU kernel's j order: no TF32,
// no atomics, no dependence on block order. Making it faster (a sliding window
// in registers, TMA staging) is later work.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRowsPerBlock = 4;
constexpr int kThreads = 256;
constexpr size_t kDefaultSharedBytes = 48 * 1024;

__global__ void __launch_bounds__(kThreads)
second_moments_kernel(const float* __restrict__ xc,
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

}  // namespace

// Launches the kernel on `stream` over contiguous f32 [rows, L] planes and
// returns cudaGetLastError() as an int (0 on success). Allocates nothing and
// does not synchronise.
extern "C" int rolling_second_moments(const void* xc, const void* yc,
                                      const void* mu_x, const void* mu_y,
                                      void* s_xx, void* s_yy, void* s_xy,
                                      long long rows, int L, int window,
                                      void* stream) {
  if (rows <= 0 || L <= 0) return 0;
  if (window < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      2ull * kRowsPerBlock * static_cast<size_t>(L + window - 1) * sizeof(float);
  if (smem > kDefaultSharedBytes) {
    const cudaError_t err = cudaFuncSetAttribute(
        second_moments_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  second_moments_kernel<<<static_cast<unsigned int>(blocks), kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xc), static_cast<const float*>(yc),
      static_cast<const float*>(mu_x), static_cast<const float*>(mu_y),
      static_cast<float*>(s_xx), static_cast<float*>(s_yy),
      static_cast<float*>(s_xy), static_cast<int64_t>(rows), L, window);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rolling_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
