// Per-stream row reductions of the plan half of a tick, for Hopper (sm_90a):
//
//   readout_kernel       o[s, j] = sum_n h[s, n] * beta[s, n, j]    (S, N), (S, N, m) -> (S, m)
//   row_abs_mean_kernel  a[s]    = (sum_i |x[s, i]|) / n           (S, n)            -> (S)
//
// Neither replaces a Pallas kernel. They replace two torch ops of the port's
// plan: the readout einsum (engine/fleet.py, cuBLAS batched gemv) and the
// drift detector's feature mean (core/drift.py, torch's reduction kernel).
// Both of those choose how to split a row's sum by the number of rows S, so
// row r of a cohort's stacked plan differed in its last bits from row r of
// the member's own plan (on an H100 at member widths 1, 3 and 1024, 16
// members each; chip_smoke.py's phase 6f checks it). Here one warp owns one
// stream: lane l sums the terms l, l + 32, l + 64, ... in that order with
// fmaf, then a fixed xor butterfly adds the 32 partial sums, so every row's
// arithmetic is the same whatever S is. The cohort's bit-for-bit guarantee
// (engine/cohort.py) rests on it.
//
// What bounds them on this card: device memory. The readout reads beta and h
// once (S N (m + 1) 4 bytes) for 2 S N m operations; the feature mean reads x
// once for 2 S n. Eight warps per block, one stream each; a warp's loads of h
// and x are coalesced, its loads of beta stride by m floats and are served
// from L1 after the first column.

#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(THREADS) readout_kernel(const float* __restrict__ h,
                                                          const float* __restrict__ beta,
                                                          float* __restrict__ out, int S, int N,
                                                          int m) {
  const int lane = threadIdx.x % 32;
  const int s = blockIdx.x * WARPS + threadIdx.x / 32;
  if (s >= S) return;  // whole warps leave together
  const float* hs = h + static_cast<size_t>(s) * N;
  const float* bs = beta + static_cast<size_t>(s) * N * m;
  for (int j = 0; j < m; ++j) {
    float acc = 0.0f;
    for (int n = lane; n < N; n += 32) acc = fmaf(hs[n], bs[static_cast<size_t>(n) * m + j], acc);
    acc = warp_sum(acc);
    if (lane == 0) out[static_cast<size_t>(s) * m + j] = acc;
  }
}

__global__ void __launch_bounds__(THREADS) row_abs_mean_kernel(const float* __restrict__ x,
                                                               float* __restrict__ out, int S,
                                                               int n) {
  const int lane = threadIdx.x % 32;
  const int s = blockIdx.x * WARPS + threadIdx.x / 32;
  if (s >= S) return;
  const float* xs = x + static_cast<size_t>(s) * n;
  float acc = 0.0f;
  for (int i = lane; i < n; i += 32) acc += fabsf(xs[i]);
  acc = warp_sum(acc);
  if (lane == 0) out[s] = acc / static_cast<float>(n);
}

unsigned int blocks_for(int S) { return static_cast<unsigned int>((S + WARPS - 1) / WARPS); }

}  // namespace

extern "C" int plan_rows_readout_launch(const void* h, const void* beta, void* out, int S, int N,
                                        int m, void* stream) {
  readout_kernel<<<blocks_for(S), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(h), static_cast<const float*>(beta), static_cast<float*>(out), S,
      N, m);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int plan_rows_abs_mean_launch(const void* x, void* out, int S, int n, void* stream) {
  row_abs_mean_kernel<<<blocks_for(S), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), S, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* plan_rows_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
