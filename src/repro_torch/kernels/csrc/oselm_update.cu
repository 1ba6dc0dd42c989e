// Fused rank-k RLS (OS-ELM) update for S independent heads, for Hopper (sm_90a):
//
//     P'[s]    = P[s] - PHt[s] @ G[s]          (rank-k Woodbury downdate)
//     beta'[s] = beta[s] + P'[s] @ W[s]        (output-weight innovation)
//
// Replaces the Pallas TPU kernels src/repro/kernels/oselm_update.py::
// oselm_rls_update_fleet (body _rls_fleet_kernel) and, as its S = 1 case,
// oselm_rls_update (body _rls_kernel). The small operands PHt (S,N,k),
// G (S,k,N) and W (S,N,m) are computed by the caller, as the JAX wrapper
// computes them outside its pallas_call. Same numerics as the Pallas body:
// no symmetrisation, beta' taken from P' @ W.
//
// What bounds it on this card: device memory. Each call must read P and
// write P' (2 * S * N^2 * 4 bytes, 2 GiB at S = 16384, N = 128), against
// 2 * S * N^2 * (k + m) FLOPs. The design reads every P element once and
// writes it once: one block owns (stream s, row tile i) and loops over the
// column tiles j inside itself, which replaces the sequential j grid axis
// the Pallas kernel accumulates beta over. Each P' tile is staged in shared
// memory, and its contribution P'[i,j] @ W[j] is added to the row tile's
// beta' accumulator (shared memory, one owner thread per element); beta' is
// written once at the end. Each thread issues all its loads of a P tile
// (PER of them, unrolled) before it uses any, so enough bytes are in flight
// to cover the memory latency. The j loop keeps the footprint at one
// (TR x TC) tile whatever N is, so N = 256 (256 KiB of P per stream) needs
// nothing extra. P' goes to a separate buffer: the wrapper allocates it.

#include <cuda_runtime.h>

namespace {

constexpr int TR = 32;        // rows of P per block
constexpr int TC = 64;        // columns of P per inner tile
constexpr int THREADS = 256;
constexpr int LD = TC + 1;    // padded row stride of the staged P' tile
constexpr int PER = TR * TC / THREADS;  // P elements per thread per tile
static_assert(TR * TC % THREADS == 0, "a tile must split evenly over the threads");

__global__ void __launch_bounds__(THREADS)
    rls_fleet_kernel(const float* __restrict__ P, const float* __restrict__ beta,
                     const float* __restrict__ pht, const float* __restrict__ g,
                     const float* __restrict__ w, float* __restrict__ p_out,
                     float* __restrict__ beta_out, int N, int k, int m, int row_tiles) {
  extern __shared__ float smem[];
  float* pht_s = smem;             // TR * k
  float* g_s = pht_s + TR * k;     // k * TC
  float* w_s = g_s + k * TC;       // TC * m
  float* pn_s = w_s + TC * m;      // TR * LD
  float* bacc = pn_s + TR * LD;    // TR * m

  const int tid = threadIdx.x;
  const int s = blockIdx.x / row_tiles;
  const int r0 = (blockIdx.x % row_tiles) * TR;
  const int rows = min(TR, N - r0);
  const size_t srow = static_cast<size_t>(s) * N;  // first row of stream s in (S*N, .) views
  const size_t pbase = srow * N;

  for (int e = tid; e < TR * k; e += THREADS) {
    const int r = e / k, q = e % k;
    pht_s[e] = r < rows ? pht[(srow + r0 + r) * k + q] : 0.0f;
  }
  for (int e = tid; e < TR * m; e += THREADS) {
    const int r = e / m, c = e % m;
    bacc[e] = r < rows ? beta[(srow + r0 + r) * m + c] : 0.0f;
  }

  for (int c0 = 0; c0 < N; c0 += TC) {
    const int cols = min(TC, N - c0);
    // Issue every P load of this tile before anything waits on memory: the
    // unrolled loop keeps PER loads in flight per thread.
    float pv[PER];
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = tid + i * THREADS;
      const int r = e / TC, c = e % TC;
      pv[i] = (r < rows && c < cols) ? P[pbase + static_cast<size_t>(r0 + r) * N + c0 + c] : 0.0f;
    }
    __syncthreads();  // the previous tile's readers are done with g_s, w_s, pn_s
    for (int e = tid; e < k * TC; e += THREADS) {
      const int q = e / TC, c = e % TC;
      g_s[e] = c < cols ? g[(static_cast<size_t>(s) * k + q) * N + c0 + c] : 0.0f;
    }
    for (int e = tid; e < TC * m; e += THREADS) {
      const int c = e / m, mm = e % m;
      w_s[e] = c < cols ? w[(srow + c0 + c) * m + mm] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = tid + i * THREADS;
      const int r = e / TC, c = e % TC;
      float v = 0.0f;
      if (r < rows && c < cols) {
        float dn = 0.0f;
        for (int q = 0; q < k; ++q) dn = fmaf(pht_s[r * k + q], g_s[q * TC + c], dn);
        v = pv[i] - dn;
        p_out[pbase + static_cast<size_t>(r0 + r) * N + c0 + c] = v;
      }
      pn_s[r * LD + c] = v;
    }
    __syncthreads();
    for (int e = tid; e < TR * m; e += THREADS) {
      const int r = e / m, mm = e % m;
      float part = 0.0f;
      for (int c = 0; c < cols; ++c) part = fmaf(pn_s[r * LD + c], w_s[c * m + mm], part);
      bacc[e] += part;
    }
  }

  // Each bacc element has one owner thread, the same in the loop above and
  // here, so no barrier is needed before the store.
  for (int e = tid; e < TR * m; e += THREADS) {
    const int r = e / m, mm = e % m;
    if (r < rows) beta_out[(srow + r0 + r) * m + mm] = bacc[e];
  }
}

}  // namespace

extern "C" int oselm_rls_fleet_smem_bytes(int k, int m) {
  return static_cast<int>(sizeof(float)) * (TR * k + k * TC + TC * m + TR * LD + TR * m);
}

extern "C" int oselm_rls_fleet_launch(const void* P, const void* beta, const void* pht,
                                      const void* g, const void* w, void* p_out,
                                      void* beta_out, int S, int N, int k, int m,
                                      void* stream) {
  const int row_tiles = (N + TR - 1) / TR;
  const int smem = oselm_rls_fleet_smem_bytes(k, m);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rls_fleet_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned int blocks = static_cast<unsigned int>(S) * static_cast<unsigned int>(row_tiles);
  rls_fleet_kernel<<<blocks, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(P), static_cast<const float*>(beta),
      static_cast<const float*>(pht), static_cast<const float*>(g),
      static_cast<const float*>(w), static_cast<float*>(p_out), static_cast<float*>(beta_out),
      N, k, m, row_tiles);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* oselm_rls_fleet_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
