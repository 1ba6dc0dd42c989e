// Rank-k RLS (OS-ELM) update for S independent heads, for Hopper (sm_90a).
// Two routes, chosen by shape in kernels/ops.py (rls_route):
//
// the single pass — the whole update in one pass over P, in one of two
// kernels (rls_rank1_cluster_kernel for k = 1 on a cluster, else
// rls_single_kernel):
//
//     PHt = P H^T,  S = I + H PHt,  G = S^-1 PHt^T,  E = Y - H beta,  W = H^T E
//     P'  = P - PHt G,               beta' = beta + P' W
//
//   Replaces the Pallas TPU kernel src/repro/kernels/oselm_update.py::
//   oselm_rls_update_fleet (body _rls_fleet_kernel, with the jnp small-operand
//   stage its wrapper runs before the pallas_call) and, as its S = 1 case,
//   oselm_rls_update (_rls_kernel). Same numerics as the Pallas body: no
//   symmetrisation, beta' taken from P' W.
//
//   What bounds it on this card: device memory. The update must read P and
//   write P' (2 * S * N^2 * 4 bytes, 2 GiB at S = 16,384, N = 128); its
//   operations (2 * S * N^2 * (2k + m)) take a tenth of that time at the f32
//   rate. The Pallas split reads P twice (PHt = P H^T in XLA, then the fused
//   pass); here each P byte is read once and written once:
//   * a cluster of C blocks owns one stream at a time, each block N/C rows
//     of its P; the clusters are persistent and walk the streams with a
//     ring of NS stages in shared memory. A stage holds the block's rows of
//     P[s], H[s] and beta[s], brought in by bulk asynchronous copies
//     (cp.async.bulk) that complete on the stage's mbarrier, so while the
//     block computes one stream the copies of the next NS - 1 are in flight;
//   * the grid holds as many clusters as the card runs at once: one block
//     an SM for a cluster of one, else cudaOccupancyMaxActiveClusters (a
//     cluster's blocks share a GPC, and a GPC's SMs need not be a multiple
//     of C: sized by SMs / C, the clusters past those that fit started only
//     when another had walked all its streams), asked once per kernel,
//     cluster and shared memory, never more clusters than streams. A
//     stream's arithmetic does not depend on the cluster that runs it, so
//     its P' and beta' are the same bits at any S and any grid;
//   * P' leaves in 16-byte streaming stores from the registers that formed
//     it, so a stage is free for the next copy as soon as its stream is
//     done (a bulk store would hold the stage until the copy engine had
//     read it);
//   * the fleet's shape, k = 1 on a block of its own (rank1_stream): lanes
//     own column chunks and warps own rows, every warp derives S, G and W
//     for its lanes' columns itself, the row sums run as butterfly
//     reductions, and a stream costs two barriers;
//   * k = 1 on a cluster (N = 256: four blocks of 64 rows), a kernel of its
//     own (rls_rank1_cluster_kernel): a stage holds only the block's rows
//     of beta; each warp forms PHt for its rows with P held in registers,
//     and the block writes its rows of PHt and its share of H beta (70
//     floats at N = 256, m = 6) into a slot in every block of the cluster, the
//     slots alternating with the stream's parity, so one cluster barrier a
//     stream replaces the general body's two and its reads of the other
//     blocks' PHt; after it the stage is refilled at once, and every block
//     derives S = 1 + h PHt over all N and E = Y - the shares summed in
//     rank order (the same bits in every block), then P' and beta' =
//     beta + (P' h) E;
//   * any other k <= 64, or a cluster the rank-1 body does not take: the
//     block's rows of PHt (rows padded to an odd stride, k + 1 floats for
//     an even k, so that the lanes of a warp reading a column of PHt fall
//     on distinct banks: at k = 32 the unpadded rows made that a 32-way
//     conflict) and its share of S from shared memory, E and W; the shares
//     of S cross through distributed shared memory after a cluster barrier;
//     every block eliminates S in full (Gauss-Jordan without pivoting, S is
//     SPD) and solves S G = PHt^T: for k a multiple of 4 (the wide forms,
//     kWide) for its own columns of G only (those of its rows of PHt), then
//     gathers the other blocks' columns between two more barriers; else for
//     all columns, from the other blocks' rows of PHt, after a second
//     barrier; then one pass forms P' and beta';
//   * one head with k >= 2 (the training path: k is the step's rows): one
//     stream leaves 131 of 132 SMs idle on one block, so the plan spreads it
//     over a cluster of blocks of 32 rows each, which split PHt, the shares
//     of S, the columns of G and the downdate.
//   kernels/oselm_update.py::single_pass_plan chooses C and NS: N = 128
//   takes C = 1 and three stages at k = 1 (C = 4 from k = 2 on), N = 256 a
//   cluster of four (three stages; at k = 1 the rank-1 cluster body).
//
// the two-stage route, rls_fleet_kernel — its second stage, for the shapes
//   the single pass does not take (N > 256, k > 64, N not a multiple of 4,
//   or a layout that does not fit in shared memory): the caller computes
//   PHt, G and W in torch, as the JAX wrapper does, and this pass computes
//   P' and beta', each P element read once and written once (one block per
//   (stream, 32-row tile), looping over 64-column tiles).
//
// P' and beta' go to separate buffers: the wrapper allocates them.
//
// Built with -DRLS_PHASE_CLOCKS (benchmarks/rls_breakdown.py does, into a
// library of its own), the single pass notes the SM clock and the global
// timer at each of its phase boundaries, in every block of cluster 0, for
// the stream of its walk that oselm_rls_phase_select names; the kernels'
// own build leaves every mark out.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace cg = cooperative_groups;

namespace {

// ---------------------------------------------------------------------------
// The single pass.
// ---------------------------------------------------------------------------

constexpr int S_THREADS = 256;
constexpr int S_WARPS = S_THREADS / 32;
constexpr int BAR_BYTES = 32;           // the stages' mbarriers, ahead of the buffers
constexpr int BULK_CHUNK = 32 * 1024;  // bytes per cp.async.bulk instruction

// Shared-memory layout of one block, in floats after the mbarriers:
// NS stages of [P rows (R x N) | H, then PHt^T, then G (k x N) | beta (N x m)],
// then W^T (m x N) | PHt rows (R x (k | 1): rows padded to an odd stride) |
// S share (k x k) | S (k x k) | E (k x m).
// With N a multiple of 4 every stage part and W^T start 16-byte aligned, as
// the bulk copies and the float4 reads need.
struct Layout {
  int R, hg, bs, stage, w, pht, s_part, s_full, e, floats;
  __host__ __device__ Layout(int N, int k, int m, int C, int NS) {
    R = N / C;
    hg = R * N;  // offsets within a stage
    bs = hg + k * N;
    stage = bs + N * m;
    w = NS * stage;
    pht = w + m * N;
    s_part = pht + R * (k | 1);
    s_full = s_part + k * k;
    e = s_full + k * k;
    floats = e + k * m;
  }
  __host__ __device__ int bytes() const { return BAR_BYTES + 4 * floats; }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Waits for the barrier's phase to complete; a copy that never lands is a
// fault, so after some 2^28 polls (seconds) the kernel traps instead of hanging.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t phase) {
  uint32_t done = 0, polls = 0;
  do {
    if (++polls == (1u << 28)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(phase)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_load(float* dst, const float* src, uint32_t bytes,
                                          uint32_t bar) {
  for (uint32_t off = 0; off < bytes; off += BULK_CHUNK) {
    const uint32_t n = min(static_cast<uint32_t>(BULK_CHUNK), bytes - off);
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
            "r"(smem_addr(dst) + off),
        "l"(reinterpret_cast<const char*>(src) + off), "r"(n), "r"(bar)
        : "memory");
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, o);
  return v;
}

// Sums each of V values (V a power of two, at most 32) over the 32 lanes of
// a warp with V - 1 + (5 - log2 V) shuffles instead of 5 V: at every step a
// lane keeps the half of its values its partner does not. Lane l ends with
// the sum of value l >> (5 - log2 V).
template <int V>
__device__ __forceinline__ float butterfly_sum(float (&v)[V], int lane) {
  static_assert(V >= 1 && V <= 32 && (V & (V - 1)) == 0, "V must be a power of two <= 32");
  int n = V;
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1) {
    if (n > 1) {
      n /= 2;
      const bool up = lane & o;
#pragma unroll
      for (int t = 0; t < V / 2; ++t) {
        if (t < n) {
          const float send = up ? v[t] : v[t + n];
          const float keep = up ? v[t + n] : v[t];
          v[t] = keep + __shfl_xor_sync(0xFFFFFFFFu, send, o);
        }
      }
    } else {
      v[0] += __shfl_xor_sync(0xFFFFFFFFu, v[0], o);
    }
  }
  return v[0];
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// The fleet's case: k = 1, a block of its own (C = 1), N <= 128, m <= 8.
// Lane l owns column chunk l (columns 4l .. 4l+3) and warp w rows w, w+8, ...
// Every warp derives S, G and W for its lanes' columns itself, so a stream
// needs two barriers; P' leaves row by row in coalesced 16-byte streaming
// stores, and the row sums of PHt and P' W run as butterfly reductions.
__device__ __forceinline__ void rank1_stream(const float* p_s, const float* h_s,
                                             const float* b_s, float* pht, float* e_s,
                                             float y, float* __restrict__ p_out,
                                             float* __restrict__ beta_out, size_t s, int N,
                                             int m, int warp, int lane) {
  constexpr int RPW = 128 / S_WARPS;  // rows per warp at most
  static_assert(RPW >= 4 && RPW <= 32 && (RPW & (RPW - 1)) == 0, "RPW: a power of two, 4 to 32");
  const int n4 = N / 4;
  const float4* p4 = reinterpret_cast<const float4*>(p_s);
  const bool has_c = lane < n4;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const float4 h = has_c ? reinterpret_cast<const float4*>(h_s)[lane] : zero;

  // 1. PHt = P H^T for this warp's rows; E = Y - H beta by warp 0.
  {
    float v[RPW];
#pragma unroll
    for (int t = 0; t < RPW; ++t) {
      const int r = warp + S_WARPS * t;
      v[t] = (has_c && r < N) ? dot4(p4[r * n4 + lane], h, 0.0f) : 0.0f;
    }
    const float sum = butterfly_sum(v, lane);
    constexpr int kShift = RPW == 16 ? 1 : RPW == 8 ? 2 : RPW == 4 ? 3 : 4;  // 5 - log2 RPW
    const int r = warp + S_WARPS * (lane >> kShift);
    if ((lane & ((1 << kShift) - 1)) == 0 && r < N) pht[r] = sum;
  }
  if (warp == 0) {
    float ev[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float acc = 0.0f;
      if (has_c && j < m) {
        const int n = 4 * lane;
        acc = fmaf(h.x, b_s[n * m + j], acc);
        acc = fmaf(h.y, b_s[(n + 1) * m + j], acc);
        acc = fmaf(h.z, b_s[(n + 2) * m + j], acc);
        acc = fmaf(h.w, b_s[(n + 3) * m + j], acc);
      }
      ev[j] = acc;
    }
    const float sum = butterfly_sum(ev, lane);
    const int j = lane >> 2;
    const float yj = __shfl_sync(0xFFFFFFFFu, y, j);  // lane j holds Y[j]
    if ((lane & 3) == 0 && j < m) e_s[j] = yj - sum;
  }
  __syncthreads();

  // 2. S = 1 + H PHt, then this lane's columns of G = PHt^T / S and of
  //    W = H^T E (k = 1: one product each).
  const float4 ph = has_c ? reinterpret_cast<const float4*>(pht)[lane] : zero;
  float sdot = dot4(h, ph, 0.0f);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sdot += __shfl_xor_sync(0xFFFFFFFFu, sdot, o);
  const float sv = 1.0f + sdot;
  const float4 g = make_float4(ph.x / sv, ph.y / sv, ph.z / sv, ph.w / sv);
  float4 w[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float e = j < m ? e_s[j] : 0.0f;
    w[j] = make_float4(h.x * e, h.y * e, h.z * e, h.w * e);
  }

  // 3. P' = P - PHt G and beta' = beta + P' W, four rows per reduction.
  float4* out4 = reinterpret_cast<float4*>(p_out + s * N * N);
#pragma unroll
  for (int b = 0; b < RPW / 4; ++b) {
    float acc[32];
#pragma unroll
    for (int tt = 0; tt < 4; ++tt) {
      const int r = warp + S_WARPS * (4 * b + tt);
      float4 v = zero;
      if (has_c && r < N) {
        const float f = pht[r];
        v = p4[r * n4 + lane];
        v.x -= __fmul_rn(f, g.x);  // P - (PHt G), two roundings, as the plain version
        v.y -= __fmul_rn(f, g.y);
        v.z -= __fmul_rn(f, g.z);
        v.w -= __fmul_rn(f, g.w);
        __stcs(out4 + r * n4 + lane, v);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[tt * 8 + j] = dot4(v, w[j], 0.0f);
    }
    const float sum = butterfly_sum(acc, lane);
    const int r = warp + S_WARPS * (4 * b + (lane >> 3)), j = lane & 7;
    if (j < m && r < N) beta_out[(s * N + r) * m + j] = b_s[r * m + j] + sum;
  }
}

// This thread's share of its block's rows of PHt = P H^T, U columns of PHt
// at a time (k a multiple of U): `tpr` lanes share a row, each taking every
// tpr-th float4 chunk from `first` on, and their sums meet by shuffles.
// Each column's sum takes the same steps whatever U is.
template <int U>
__device__ __forceinline__ void pht_rows(const float* p_s, const float* hg, float* pht, int k,
                                         int kp, int n4, int row, int part, int tpr, int nch,
                                         int first, bool has_row) {
  const float4* p4 = reinterpret_cast<const float4*>(p_s);
  const float4* h4 = reinterpret_cast<const float4*>(hg);
  for (int q0 = 0; q0 < k; q0 += U) {
    float acc[U];
#pragma unroll
    for (int u = 0; u < U; ++u) acc[u] = 0.0f;
    if (has_row) {
      for (int it = 0, ci = first; it < nch; ++it, ci = ci + 1 == nch ? 0 : ci + 1) {
        const int c = ci * tpr + part;
        if (c >= n4) continue;
        const float4 a = p4[row * n4 + c];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const float4 b = h4[(q0 + u) * n4 + c];
          acc[u] = fmaf(a.x, b.x, acc[u]);
          acc[u] = fmaf(a.y, b.y, acc[u]);
          acc[u] = fmaf(a.z, b.z, acc[u]);
          acc[u] = fmaf(a.w, b.w, acc[u]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      for (int o = tpr / 2; o > 0; o >>= 1) acc[u] += __shfl_xor_sync(0xFFFFFFFFu, acc[u], o);
      if (has_row && part == 0) pht[row * kp + q0 + u] = acc[u];
    }
  }
}

#ifdef RLS_PHASE_CLOCKS
constexpr int N_MARKS = 9;
constexpr int MARK_RANKS = 4;  // the blocks of a cluster, each marked on its own SM's clock
// (clock64, globaltimer) per (block rank of cluster 0, mark), for the stream
// of cluster 0 whose index within the cluster's walk is rls_mark_stream
// (mark 0, the kernel's start, only when that index is 0).
__device__ unsigned long long rls_marks[MARK_RANKS * 2 * N_MARKS];
__device__ int rls_mark_stream;

__device__ __forceinline__ void phase_mark(int at, int stream_i) {
  uint32_t cid, rank;
  asm volatile("mov.u32 %0, %%clusterid.x;" : "=r"(cid));
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(rank));
  if (cid == 0 && rank < MARK_RANKS && threadIdx.x == 0 && stream_i == rls_mark_stream) {
    unsigned long long ns;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
    rls_marks[2 * (rank * N_MARKS + at)] = static_cast<unsigned long long>(clock64());
    rls_marks[2 * (rank * N_MARKS + at) + 1] = ns;
  }
}
#define RLS_MARK(at, stream_i) phase_mark(at, stream_i)
#else
#define RLS_MARK(at, stream_i) ((void)0)
#endif

// kWide: k is a multiple of 4, and the general path takes its wide forms:
// PHt four columns at a time, the S share spread over all threads, and on a
// cluster each block solving for its own columns of G. The other
// instantiation (the fleet's k = 1 among others) carries none of their code:
// on an H100 the N = 256, k = 1 update ran 4 % slower with it.
template <bool kWide>
__global__ void __launch_bounds__(S_THREADS, 1)
    rls_single_kernel(const float* __restrict__ P, const float* __restrict__ beta,
                      const float* __restrict__ H, const float* __restrict__ Y,
                      float* __restrict__ p_out, float* __restrict__ beta_out, int S, int N,
                      int k, int m, int NS) {
  extern __shared__ __align__(128) unsigned char raw[];
  RLS_MARK(0, 0);
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const Layout L(N, k, m, C, NS);
  const int R = L.R;
  const int r0 = rank * R;
  const int n_clusters = gridDim.x / C, cid = blockIdx.x / C;
  const int count = cid < S ? (S - cid + n_clusters - 1) / n_clusters : 0;

  uint64_t* bars = reinterpret_cast<uint64_t*>(raw);
  float* sm = reinterpret_cast<float*>(raw + BAR_BYTES);
  float* w_s = sm + L.w;
  float* pht = sm + L.pht;
  float* s_part = sm + L.s_part;
  float* s_full = sm + L.s_full;
  float* e_s = sm + L.e;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n4 = N / 4;
  const int kp = k | 1;  // PHt's row stride, odd: a column's R values fall on distinct banks
  const uint32_t p_bytes = static_cast<uint32_t>(R) * N * 4;
  const uint32_t h_bytes = static_cast<uint32_t>(k) * N * 4;
  const uint32_t b_bytes = static_cast<uint32_t>(N) * m * 4;

  // Row-parallel passes over P: `tpr` lanes share a row of this block,
  // each taking every tpr-th float4 chunk, in an order staggered by row so
  // that the lanes of a warp read distinct banks.
  int tpr = 32;
  while (tpr > 1 && R * tpr > S_THREADS) tpr >>= 1;
  const int row = tid / tpr, part = tid % tpr;
  const bool has_row = row < R;
  const int nch = (n4 + tpr - 1) / tpr;
  const int first = has_row ? row % nch : 0;

  // Within a cluster: a cluster barrier and the other blocks' shared memory;
  // a cluster of one needs neither.
  auto sync_cluster = [&] {
    if (C > 1) {
      cluster.sync();
    } else {
      __syncthreads();
    }
  };
  auto peer = [&](float* p, int c) { return C > 1 ? cluster.map_shared_rank(p, c) : p; };

  // The i-th stream of this cluster into stage i % NS (thread 0 only).
  auto fetch = [&](int i) {
    const int st = i % NS;
    const size_t s = static_cast<size_t>(cid) + static_cast<size_t>(i) * n_clusters;
    float* stage = sm + st * L.stage;
    const uint32_t bar = smem_addr(bars + st);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
                 "r"(p_bytes + h_bytes + b_bytes)
                 : "memory");
    bulk_load(stage, P + (s * N + r0) * N, p_bytes, bar);
    bulk_load(stage + L.hg, H + s * k * N, h_bytes, bar);
    bulk_load(stage + L.bs, beta + s * N * m, b_bytes, bar);
  };

  if (tid == 0) {
    for (int st = 0; st < NS; ++st)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bars + st)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int i = 0; i < min(NS, count); ++i) fetch(i);
  }
  __syncthreads();

  // Y of the next stream is loaded one stream ahead, into a register.
  const int km = k * m;
  const bool rank1 = k == 1 && C == 1 && N <= 128 && m <= 8;

  // The wide form's shapes of work, the same for every stream: lanes per
  // (q, q2) of the S share (a power of two, 2^lsh); the columns [c0, c0 +
  // nc) of G this block solves for (its own); the solve's thread mapping.
  int lsh = 5;
  while (lsh > 0 && (k * k << lsh) > S_THREADS) --lsh;
  const int lpp = 1 << lsh;
  const int c0 = r0, nc = R;
  const int wsh = k <= 33 ? 5 : 6, w = 1 << wsh;  // 32 or 64 columns of S a row of threads
  const int rhs_n = c0 + tid % nc, rhs_step = S_THREADS / nc;
  const int rhs_rw = tid < rhs_step * nc ? tid / nc : k;
  float y_next = (count > 0 && tid < km) ? Y[static_cast<size_t>(cid) * km + tid] : 0.0f;

  for (int i = 0; i < count; ++i) {
    const int st = i % NS;
    const size_t s = static_cast<size_t>(cid) + static_cast<size_t>(i) * n_clusters;
    float* p_s = sm + st * L.stage;
    float* hg = p_s + L.hg;
    const float* b_s = p_s + L.bs;
    const float y_cur = y_next;
    if (i + 1 < count && tid < km) y_next = Y[(s + n_clusters) * km + tid];
    RLS_MARK(1, i);
    mbar_wait(smem_addr(bars + st), (i / NS) & 1);
    RLS_MARK(2, i);

    if (rank1) {
      rank1_stream(p_s, hg, b_s, pht, e_s, y_cur, p_out, beta_out, s, N, m, warp, lane);
    } else {  // any k <= 64, clusters of 1, 2 or 4 blocks
      // 1. This block's rows of PHt = P H^T (four columns at a time where k
      //    allows, each chunk of P read once for the four).
      pht_rows<kWide ? 4 : 1>(p_s, hg, pht, k, kp, n4, row, part, tpr, nch, first, has_row);
      if (tid < km) e_s[tid] = y_cur;
      for (int j = tid + S_THREADS; j < km; j += S_THREADS) e_s[j] = Y[s * km + j];
      __syncthreads();
      RLS_MARK(3, i);

      // 2. This block's share of S = I + H PHt (a sum over its rows), and
      //    E = Y - H beta, then W^T = (H^T E)^T.
      //    kWide: each (q, q2) of the share takes lpp lanes (fewer as k
      //    grows, one from k = 16 on), so that every thread has work and few
      //    shuffles; else a warp each.
      if constexpr (kWide) {
        for (int base = 0; base < k * k; base += S_THREADS >> lsh) {
          if (base + ((warp * 32) >> lsh) >= k * k) break;  // this warp has no pair left
          const int pair = base + (tid >> lsh), sub = tid & (lpp - 1);
          float acc = 0.0f;
          if (pair < k * k) {
            const int q = pair / k, q2 = pair % k;
            for (int r = sub; r < R; r += lpp) acc = fmaf(hg[q * N + r0 + r], pht[r * kp + q2], acc);
          }
          for (int o = lpp / 2; o > 0; o >>= 1) acc += __shfl_xor_sync(0xFFFFFFFFu, acc, o);
          if (pair < k * k && sub == 0) s_part[pair] = acc;
        }
      } else {
        for (int pair = warp; pair < k * k; pair += S_WARPS) {
          const int q = pair / k, q2 = pair % k;
          float acc = 0.0f;
          for (int r = lane; r < R; r += 32) acc = fmaf(hg[q * N + r0 + r], pht[r * kp + q2], acc);
          acc = warp_sum(acc);
          if (lane == 0) s_part[pair] = acc;
        }
      }
      for (int pair = warp; pair < km; pair += S_WARPS) {
        const int q = pair / m, j = pair % m;
        float acc = 0.0f;
        for (int n = lane; n < N; n += 32) acc = fmaf(hg[q * N + n], b_s[n * m + j], acc);
        acc = warp_sum(acc);
        if (lane == 0) e_s[pair] -= acc;
      }
      __syncthreads();
      RLS_MARK(4, i);
      for (int j = tid; j < m * N; j += S_THREADS) {
        const int jj = j / N, n = j % N;
        float acc = 0.0f;
        for (int q = 0; q < k; ++q) acc = fmaf(hg[q * N + n], e_s[q * m + jj], acc);
        w_s[j] = acc;
      }

      // 3. Across the cluster: S = I + the sum of the shares, and the
      //    right-hand side PHt^T over H, which no one reads any more.
      //    kWide on a cluster: each block solves for its own columns of G
      //    only (those of its rows of PHt, in its own shared memory) and the
      //    columns cross after the solve (steps 4w); else every block takes
      //    all columns from the other blocks' rows of PHt, after which the
      //    second barrier also keeps the other blocks from overwriting their
      //    PHt and S share (next stream) before this block has read them
      //    (with own columns the barriers around the exchange of G do that).
      sync_cluster();
      RLS_MARK(5, i);
      for (int j = tid; j < k * k; j += S_THREADS) {
        float acc = 0.0f;
        for (int c = 0; c < C; ++c) acc += peer(s_part, c)[j];
        s_full[j] = (j / k == j % k ? 1.0f : 0.0f) + acc;
      }
      if constexpr (kWide) {
        for (int j = tid; j < k * nc; j += S_THREADS) {
          const int q = j / nc, n = c0 + j % nc;
          hg[q * N + n] = pht[(n - r0) * kp + q];
        }
        __syncthreads();
      } else {
        for (int j = tid; j < k * N; j += S_THREADS) {
          const int q = j / N, n = j % N, owner = n / R;
          hg[j] = peer(pht, owner)[(n - owner * R) * kp + q];
        }
        sync_cluster();
      }
      RLS_MARK(6, i);

      // 4. G = S^-1 PHt^T in place: Gauss-Jordan without pivoting (S is SPD),
      //    S in full in every block. Columns of S left of the pivot are
      //    never read again, so each step updates only the columns right of
      //    it. Each element takes the same steps on either form.
      if constexpr (kWide) {
        // 4w. Columns [c0, c0 + nc), with no index divided in the steps: a
        //     thread takes S's column pv + 1 + tid % w of rows tid / w,
        //     + 256 / w, ..., and the right-hand side's column
        //     c0 + tid % nc of rows tid / nc, + 256 / nc, ... (threads past
        //     the last whole row of columns idle).
        for (int pv = 0; pv < k; ++pv) {
          const float d = s_full[pv * k + pv];  // never written below: the scaling starts right of it
          if (tid < k - pv - 1) s_full[pv * k + pv + 1 + tid] /= d;
          for (int n = c0 + tid; n < c0 + nc; n += S_THREADS) hg[pv * N + n] /= d;
          __syncthreads();
          const int col = pv + 1 + (tid & (w - 1));
          if (col < k) {
            for (int rw = tid >> wsh; rw < k - 1; rw += S_THREADS >> wsh) {
              const int rr = rw < pv ? rw : rw + 1;  // every row but the pivot's
              s_full[rr * k + col] -= s_full[rr * k + pv] * s_full[pv * k + col];
            }
          }
          for (int rw = rhs_rw; rw < k - 1; rw += rhs_step) {
            const int rr = rw < pv ? rw : rw + 1;
            hg[rr * N + rhs_n] -= s_full[rr * k + pv] * hg[pv * N + rhs_n];
          }
          __syncthreads();
        }
        //     Every block's columns of G from their owners: after the first
        //     barrier all are solved; the second keeps each block's columns
        //     in place (its next stream's copies land on this stage) until
        //     every other block has read them.
        if (C > 1) {
          cluster.sync();
          for (int j = tid; j < k * N; j += S_THREADS) {
            const int owner = (j % N) / R;
            if (owner != rank) hg[j] = peer(hg, owner)[j];
          }
          cluster.sync();
        }
      } else {
        for (int pv = 0; pv < k; ++pv) {
          const float d = s_full[pv * k + pv];
          for (int j = pv + 1 + tid; j < k; j += S_THREADS) s_full[pv * k + j] /= d;
          for (int n = tid; n < N; n += S_THREADS) hg[pv * N + n] /= d;
          __syncthreads();
          for (int j = tid; j < (k - 1) * (k - pv); j += S_THREADS) {
            const int rw = j / (k - pv), col = pv + j % (k - pv);
            const int rr = rw < pv ? rw : rw + 1;
            if (col > pv) s_full[rr * k + col] -= s_full[rr * k + pv] * s_full[pv * k + col];
          }
          for (int j = tid; j < (k - 1) * N; j += S_THREADS) {
            const int rw = j / N, n = j % N;
            const int rr = rw < pv ? rw : rw + 1;
            hg[rr * N + n] -= s_full[rr * k + pv] * hg[pv * N + n];
          }
          __syncthreads();
        }
      }
      RLS_MARK(7, i);

      // 5. One pass over this block's rows: P' = P - PHt G goes straight from
      //    registers to device memory (16-byte streaming stores), and its
      //    products with W^T accumulate beta' = beta + P' W, MMAX outputs per
      //    pass (P' is kept in shared memory only when m needs more passes).
      float4* p4 = reinterpret_cast<float4*>(p_s);
      const float4* g4 = reinterpret_cast<const float4*>(hg);
      const float4* w4 = reinterpret_cast<const float4*>(w_s);
      float4* out4 = reinterpret_cast<float4*>(p_out + (s * N + r0) * N);
      constexpr int MMAX = 8;
      for (int j0 = 0; j0 < m; j0 += MMAX) {
        float acc[MMAX];
#pragma unroll
        for (int j = 0; j < MMAX; ++j) acc[j] = 0.0f;
        if (has_row) {
          for (int it = 0, ci = first; it < nch; ++it, ci = ci + 1 == nch ? 0 : ci + 1) {
            const int c = ci * tpr + part;
            if (c >= n4) continue;
            float4 v = p4[row * n4 + c];
            if (j0 == 0) {
              float4 dn = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
              for (int q = 0; q < k; ++q) {
                const float f = pht[row * kp + q];
                const float4 g = g4[q * n4 + c];
                dn.x = fmaf(f, g.x, dn.x);
                dn.y = fmaf(f, g.y, dn.y);
                dn.z = fmaf(f, g.z, dn.z);
                dn.w = fmaf(f, g.w, dn.w);
              }
              v.x -= dn.x;
              v.y -= dn.y;
              v.z -= dn.z;
              v.w -= dn.w;
              __stcs(out4 + row * n4 + c, v);
              if (m > MMAX) p4[row * n4 + c] = v;  // read back, by this thread only, below
            }
#pragma unroll
            for (int j = 0; j < MMAX; ++j) {
              if (j0 + j < m) {
                const float4 w = w4[(j0 + j) * n4 + c];
                acc[j] = fmaf(v.x, w.x, acc[j]);
                acc[j] = fmaf(v.y, w.y, acc[j]);
                acc[j] = fmaf(v.z, w.z, acc[j]);
                acc[j] = fmaf(v.w, w.w, acc[j]);
              }
            }
          }
        }
#pragma unroll
        for (int j = 0; j < MMAX; ++j) {
          for (int o = tpr / 2; o > 0; o >>= 1) acc[j] += __shfl_xor_sync(0xFFFFFFFFu, acc[j], o);
        }
        if (has_row && part == 0) {
          const size_t out = (s * N + r0 + row) * m;
          for (int j = 0; j < MMAX && j0 + j < m; ++j)
            beta_out[out + j0 + j] = b_s[(r0 + row) * m + j0 + j] + acc[j];
        }
      }

    }

    // 6. Once every thread is done with the stage, it takes the stream NS
    //    ahead.
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    RLS_MARK(8, i);
    if (tid == 0 && i + NS < count) fetch(i + NS);
  }
}

// ---------------------------------------------------------------------------
// The fleet's k = 1 on a cluster: rls_rank1_cluster_kernel.
// ---------------------------------------------------------------------------

constexpr int RC_MAX_ROWS = 64;               // rows of P a block holds at most
constexpr int RC_RPW = RC_MAX_ROWS / S_WARPS;  // rows a warp holds at most
constexpr int RC_MMAX = 8;                    // outputs m at most
constexpr int RC_E = 8;  // floats of a slot after its rows of PHt: the block's share of H beta

// Whether a cluster of C blocks runs (N, k, m) with the rank-1 cluster body;
// kernels/oselm_update.py::rank1_cluster says the same.  A lane owns float4
// chunks l and l + 32 of a row (N <= 256), a warp rows w, w + 8, ... (R <=
// 64), and a slot's PHt and a stage's beta rows stay 16-byte aligned (R a
// multiple of 4).
__host__ __device__ inline bool rank1_cluster(int N, int k, int m, int C) {
  const int R = N / C;
  return k == 1 && C > 1 && m <= RC_MMAX && N <= 256 && R <= RC_MAX_ROWS && R % 4 == 0;
}

// Shared-memory layout of one block of the rank-1 cluster body, in floats
// after the mbarriers: NS stages of [its R rows of P (R x N) | h (N) | its R
// rows of beta (R x m)], then two exchange areas (by the parity of the
// stream's index) of C slots, one per block rank: that block's R values of
// PHt, then its share of H beta (RC_E floats).
struct Rank1Layout {
  int R, h, bs, stage, slots, slot, floats;
  __host__ __device__ Rank1Layout(int N, int m, int C, int NS) {
    R = N / C;
    h = R * N;  // offsets within a stage
    bs = h + N;
    stage = bs + R * m;
    slots = NS * stage;
    slot = R + RC_E;
    floats = slots + 2 * C * slot;
  }
  __host__ __device__ int bytes() const { return BAR_BYTES + 4 * floats; }
};

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// The update at k = 1 with a stream's rows of P split over a cluster of C
// blocks (N = 256: four of 64 rows), one cluster barrier a stream:
//   1. each warp forms PHt for its rows (P and h from the stage, P kept in
//      registers), warp 0 the block's share e_b = h[r0:r0+R] beta[r0:r0+R];
//      the lanes write both into this block's slot in every block of the
//      cluster (distributed shared memory; slots alternate by the stream's
//      parity, so the barrier of stream i + 1 keeps stream i + 2's writes
//      off a slot until every block has read it);
//   2. after the barrier every block holds all of PHt: thread 0 refills the
//      stage (every thread read it before the barrier), and every lane
//      derives S = 1 + h PHt over all N (the same steps in every warp and
//      every block, so the same bits), E = Y - (e_0 + ... + e_{C-1}) in
//      rank order, and its columns of G = PHt^T / S;
//   3. P' = P - PHt G (two roundings, as the plain version) leaves in
//      16-byte streaming stores, and beta' = beta + P' W with W = h^T E
//      taken as (P' h) E: one butterfly-reduced product per row, then one
//      fma per output.
__global__ void __launch_bounds__(S_THREADS, 1)
    rls_rank1_cluster_kernel(const float* __restrict__ P, const float* __restrict__ beta,
                             const float* __restrict__ H, const float* __restrict__ Y,
                             float* __restrict__ p_out, float* __restrict__ beta_out, int S,
                             int N, int m, int NS) {
  extern __shared__ __align__(128) unsigned char raw[];
  RLS_MARK(0, 0);
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const Rank1Layout L(N, m, C, NS);
  const int R = L.R, r0 = rank * R, n4 = N / 4;
  const int n_clusters = gridDim.x / C, cid = blockIdx.x / C;
  const int count = cid < S ? (S - cid + n_clusters - 1) / n_clusters : 0;

  uint64_t* bars = reinterpret_cast<uint64_t*>(raw);
  float* sm = reinterpret_cast<float*>(raw + BAR_BYTES);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const uint32_t p_bytes = static_cast<uint32_t>(R) * N * 4;
  const uint32_t h_bytes = static_cast<uint32_t>(N) * 4;
  const uint32_t b_bytes = static_cast<uint32_t>(R) * m * 4;

  // The i-th stream of this cluster into stage i % NS (thread 0 only).
  auto fetch = [&](int i) {
    const int st = i % NS;
    const size_t s = static_cast<size_t>(cid) + static_cast<size_t>(i) * n_clusters;
    float* stage = sm + st * L.stage;
    const uint32_t bar = smem_addr(bars + st);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
                 "r"(p_bytes + h_bytes + b_bytes)
                 : "memory");
    bulk_load(stage, P + (s * N + r0) * N, p_bytes, bar);
    bulk_load(stage + L.h, H + s * N, h_bytes, bar);
    bulk_load(stage + L.bs, beta + (s * N + r0) * m, b_bytes, bar);
  };

  // This lane's float4 chunks of a row, the row whose sums it holds after a
  // butterfly over its warp's rows (in four lanes: the lane's `peer` names
  // the block whose slot it writes), and its two outputs of beta'.
  const int c0 = lane, c1 = lane + 32;
  const bool has0 = c0 < n4, has1 = c1 < n4;
  const int rq = warp + S_WARPS * (lane >> 2);
  const int peer = lane & 3;
  const int j0 = lane & 3, j1 = j0 + 4;
  float* peer_area = cluster.map_shared_rank(sm + L.slots, peer < C ? peer : rank);
  const int area_floats = C * L.slot;

  if (tid == 0) {
    for (int st = 0; st < NS; ++st)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bars + st)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int i = 0; i < min(NS, count); ++i) fetch(i);
  }
  // Every block of the cluster has started (and this block's barriers are
  // set) before any block writes into another's shared memory.
  cluster_arrive();
  cluster_wait();

  // Y of the next stream is loaded one stream ahead, into registers.
  float y_next0 = 0.0f, y_next1 = 0.0f;
  if (count > 0) {
    if (j0 < m) y_next0 = Y[static_cast<size_t>(cid) * m + j0];
    if (j1 < m) y_next1 = Y[static_cast<size_t>(cid) * m + j1];
  }
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  for (int i = 0; i < count; ++i) {
    const int st = i % NS;
    const size_t s = static_cast<size_t>(cid) + static_cast<size_t>(i) * n_clusters;
    const float* p_s = sm + st * L.stage;
    const float* h_s = p_s + L.h;
    const float* b_s = p_s + L.bs;
    float* area = sm + L.slots + (i & 1) * area_floats;
    float* mine = peer_area + (i & 1) * area_floats + rank * L.slot;  // this block's slot in `peer`
    const float y0 = y_next0, y1 = y_next1;
    RLS_MARK(1, i);
    mbar_wait(smem_addr(bars + st), (i / NS) & 1);
    RLS_MARK(2, i);

    // 1. PHt for this warp's rows, P kept in registers; beta's rows for
    //    this lane's outputs; the block's share of H beta (warp 0).
    const float4* p4 = reinterpret_cast<const float4*>(p_s);
    const float4* h4 = reinterpret_cast<const float4*>(h_s);
    const float4 h0 = has0 ? h4[c0] : zero, h1 = has1 ? h4[c1] : zero;
    float4 pv[RC_RPW][2];
    float v[RC_RPW];
#pragma unroll
    for (int t = 0; t < RC_RPW; ++t) {
      const int r = warp + S_WARPS * t;
      pv[t][0] = (has0 && r < R) ? p4[r * n4 + c0] : zero;
      pv[t][1] = (has1 && r < R) ? p4[r * n4 + c1] : zero;
      v[t] = dot4(pv[t][1], h1, dot4(pv[t][0], h0, 0.0f));
    }
    const float pht_r = butterfly_sum(v, lane);  // row rq, in its four lanes alike
    const float b_pre0 = (rq < R && j0 < m) ? b_s[rq * m + j0] : 0.0f;
    const float b_pre1 = (rq < R && j1 < m) ? b_s[rq * m + j1] : 0.0f;
    if (warp == 0) {
      float ev[RC_MMAX];
#pragma unroll
      for (int j = 0; j < RC_MMAX; ++j) {
        float acc = 0.0f;
        if (j < m) {
          if (lane < R) acc = fmaf(h_s[r0 + lane], b_s[lane * m + j], acc);
          if (lane + 32 < R) acc = fmaf(h_s[r0 + lane + 32], b_s[(lane + 32) * m + j], acc);
        }
        ev[j] = acc;
      }
      const float e = butterfly_sum(ev, lane);  // output lane >> 2, in its four lanes alike
      if (peer < C && (lane >> 2) < m) mine[R + (lane >> 2)] = e;
    }
    if (peer < C && rq < R) mine[rq] = pht_r;
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // the reads above, before the refill
    RLS_MARK(3, i);
    cluster_arrive();
    if (i + 1 < count) {  // the next stream's Y, while the other blocks arrive
      if (j0 < m) y_next0 = Y[(s + n_clusters) * m + j0];
      if (j1 < m) y_next1 = Y[(s + n_clusters) * m + j1];
    }
    cluster_wait();
    RLS_MARK(4, i);
    if (tid == 0 && i + NS < count) fetch(i + NS);

    // 2. S = 1 + h PHt, E = Y - sum of the blocks' shares (rank order), and
    //    this lane's columns of G = PHt^T / S.
    float4 ph0 = zero, ph1 = zero;
    if (has0) ph0 = *reinterpret_cast<const float4*>(area + (4 * c0 / R) * L.slot + 4 * c0 % R);
    if (has1) ph1 = *reinterpret_cast<const float4*>(area + (4 * c1 / R) * L.slot + 4 * c1 % R);
    float sdot = dot4(h1, ph1, dot4(h0, ph0, 0.0f));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sdot += __shfl_xor_sync(0xFFFFFFFFu, sdot, o);
    const float sv = 1.0f + sdot;
    const float4 g0 = make_float4(ph0.x / sv, ph0.y / sv, ph0.z / sv, ph0.w / sv);
    const float4 g1 = make_float4(ph1.x / sv, ph1.y / sv, ph1.z / sv, ph1.w / sv);
    float hb0 = 0.0f, hb1 = 0.0f;
    for (int b = 0; b < C; ++b) {
      if (j0 < m) hb0 += area[b * L.slot + R + j0];
      if (j1 < m) hb1 += area[b * L.slot + R + j1];
    }
    const float e0 = y0 - hb0, e1 = y1 - hb1;
    RLS_MARK(5, i);

    // 3. P' = P - PHt G for this warp's rows, and q = P' h by rows.
    const float* pht = area + rank * L.slot;
    float4* out4 = reinterpret_cast<float4*>(p_out + (s * N + r0) * N);
    float q[RC_RPW];
#pragma unroll
    for (int t = 0; t < RC_RPW; ++t) {
      const int r = warp + S_WARPS * t;
      const float f = r < R ? pht[r] : 0.0f;
      float4 a = pv[t][0], b = pv[t][1];
      a.x -= __fmul_rn(f, g0.x);  // P - (PHt G), two roundings, as the plain version
      a.y -= __fmul_rn(f, g0.y);
      a.z -= __fmul_rn(f, g0.z);
      a.w -= __fmul_rn(f, g0.w);
      b.x -= __fmul_rn(f, g1.x);
      b.y -= __fmul_rn(f, g1.y);
      b.z -= __fmul_rn(f, g1.z);
      b.w -= __fmul_rn(f, g1.w);
      if (r < R) {
        if (has0) __stcs(out4 + r * n4 + c0, a);
        if (has1) __stcs(out4 + r * n4 + c1, b);
      }
      q[t] = dot4(b, h1, dot4(a, h0, 0.0f));
    }
    const float qr = butterfly_sum(q, lane);  // row rq
    if (rq < R) {
      const size_t o = (s * N + r0 + rq) * m;
      if (j0 < m) beta_out[o + j0] = fmaf(qr, e0, b_pre0);
      if (j1 < m) beta_out[o + j1] = fmaf(qr, e1, b_pre1);
    }
    RLS_MARK(8, i);
  }
}

// ---------------------------------------------------------------------------
// The second stage of the two-stage route.
// ---------------------------------------------------------------------------

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

// The kernels of the single pass: 0 and 1 the general body (kWide false and
// true), 2 the rank-1 cluster body.
int single_body(int N, int k, int m, int C) {
  return rank1_cluster(N, k, m, C) ? 2 : k % 4 == 0 ? 1 : 0;
}

const void* single_kernel(int body) {
  return body == 2   ? reinterpret_cast<const void*>(rls_rank1_cluster_kernel)
         : body == 1 ? reinterpret_cast<const void*>(rls_single_kernel<true>)
                     : reinterpret_cast<const void*>(rls_single_kernel<false>);
}

int single_smem(int N, int k, int m, int C, int NS) {
  return rank1_cluster(N, k, m, C) ? Rank1Layout(N, m, C, NS).bytes()
                                   : Layout(N, k, m, C, NS).bytes();
}

std::mutex single_mutex;

// Opts the body's kernel into `smem` bytes of dynamic shared memory (each
// kernel keeps the largest asked for so far).
cudaError_t single_opt_in(int body, int smem) {
  static int smem_set[3] = {0, 0, 0};
  std::lock_guard<std::mutex> lock(single_mutex);
  if (smem <= smem_set[body]) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(single_kernel(body), cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) smem_set[body] = smem;
  return err;
}

// How many clusters of C blocks of the body, with `smem` bytes each, the
// card runs at once: its SMs for a cluster of one block (one block an SM),
// else cudaOccupancyMaxActiveClusters (a cluster's blocks share a GPC, and a
// GPC's SMs need not be a multiple of C), asked once per (device, kernel, C,
// shared memory) and kept.
cudaError_t resident_clusters(int body, int C, int smem, int* out) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (C == 1) return cudaDeviceGetAttribute(out, cudaDevAttrMultiProcessorCount, device);
  struct Fit {
    int device, body, C, smem, clusters;
  };
  static Fit fits[64];
  static int n_fits = 0;
  std::lock_guard<std::mutex> lock(single_mutex);
  for (int i = 0; i < n_fits; ++i) {
    const Fit& f = fits[i];
    if (f.device == device && f.body == body && f.C == C && f.smem == smem) {
      *out = f.clusters;
      return cudaSuccess;
    }
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned int>(C));
  cfg.blockDim = dim3(S_THREADS);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned int>(C);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, single_kernel(body), &cfg);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorLaunchOutOfResources;
  if (n_fits < 64) fits[n_fits++] = Fit{device, body, C, smem, clusters};
  *out = clusters;
  return cudaSuccess;
}

}  // namespace

extern "C" int oselm_rls_single_smem_bytes(int N, int k, int m, int C, int NS) {
  return single_smem(N, k, m, C, NS);
}

// The clusters a launch of S streams runs (persistent, each walking the
// streams cid, cid + clusters, ...): as many as the card holds at once
// (resident_clusters), never more than streams; `max_clusters` > 0 asks for
// that many instead (at most S; timings and tests use it to shrink or
// overfill the grid: a stream's arithmetic does not depend on it).
extern "C" int oselm_rls_single_clusters(int S, int N, int k, int m, int C, int NS,
                                         int max_clusters, int* out) {
  const int body = single_body(N, k, m, C);
  const int smem = single_smem(N, k, m, C, NS);
  cudaError_t err = single_opt_in(body, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int fit = 0;
  if (max_clusters > 0) {
    fit = max_clusters;
  } else {
    err = resident_clusters(body, C, smem, &fit);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  *out = max(1, min(S, fit));
  return 0;
}

extern "C" int oselm_rls_single_launch(const void* P, const void* beta, const void* H,
                                       const void* Y, void* p_out, void* beta_out, int S, int N,
                                       int k, int m, int C, int NS, int max_clusters,
                                       void* stream) {
  int clusters = 0;
  const int rc = oselm_rls_single_clusters(S, N, k, m, C, NS, max_clusters, &clusters);
  if (rc != 0) return rc;
  const int body = single_body(N, k, m, C);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned int>(clusters * C));
  cfg.blockDim = dim3(S_THREADS);
  cfg.dynamicSmemBytes = static_cast<size_t>(single_smem(N, k, m, C, NS));
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned int>(C);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const float* p = static_cast<const float*>(P);
  const float* b = static_cast<const float*>(beta);
  const float* h = static_cast<const float*>(H);
  const float* y = static_cast<const float*>(Y);
  float* po = static_cast<float*>(p_out);
  float* bo = static_cast<float*>(beta_out);
  cudaError_t err;
  if (body == 2) {
    err = cudaLaunchKernelEx(&cfg, rls_rank1_cluster_kernel, p, b, h, y, po, bo, S, N, m, NS);
  } else {
    err = cudaLaunchKernelEx(&cfg, body == 1 ? rls_single_kernel<true> : rls_single_kernel<false>,
                             p, b, h, y, po, bo, S, N, k, m, NS);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

#ifdef RLS_PHASE_CLOCKS
// The marks of the last launch (MARK_RANKS * 2 * N_MARKS values: block rank,
// then mark, then (cycles, ns)), a reset to 0, and the stream to mark.
extern "C" int oselm_rls_phase_marks(unsigned long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, rls_marks, sizeof(rls_marks)));
}

extern "C" int oselm_rls_phase_reset() {
  static const unsigned long long zeros[MARK_RANKS * 2 * N_MARKS] = {};
  return static_cast<int>(cudaMemcpyToSymbol(rls_marks, zeros, sizeof(zeros)));
}

extern "C" int oselm_rls_phase_select(int stream_i) {
  return static_cast<int>(cudaMemcpyToSymbol(rls_mark_stream, &stream_i, sizeof(int)));
}
#endif

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
