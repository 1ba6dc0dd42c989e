// Rank-k RLS (OS-ELM) update for S independent heads, for Hopper (sm_90a).
// Two kernels, chosen by shape in kernels/ops.py (rls_route):
//
// rls_single_kernel — the whole update in one pass over P:
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
//     of its P; the clusters are persistent (one block per SM) and walk the
//     streams with a ring of NS stages in shared memory. A stage holds the
//     block's rows of P[s], H[s] and beta[s], brought in by bulk
//     asynchronous copies (cp.async.bulk) that complete on the stage's
//     mbarrier, so while the block computes one stream the copies of the
//     next NS - 1 are in flight;
//   * P' leaves in 16-byte streaming stores from the registers that formed
//     it, so a stage is free for the next copy as soon as its stream is
//     done (a bulk store would hold the stage until the copy engine had
//     read it);
//   * the fleet's shape, k = 1 on a block of its own (rank1_stream): lanes
//     own column chunks and warps own rows, every warp derives S, G and W
//     for its lanes' columns itself, the row sums run as butterfly
//     reductions, and a stream costs two barriers;
//   * any other k <= 64, or N = 256 on a cluster: the block's rows of PHt
//     and its share of S from shared memory, E and W; the shares of S and
//     the rows of PHt of the other blocks cross through distributed shared
//     memory between two cluster barriers; every block solves S G = PHt^T
//     for the whole k x N right-hand side (Gauss-Jordan without pivoting, S
//     is SPD); then one pass forms P' and beta'.
//   kernels/oselm_update.py::single_pass_plan chooses C and NS: N = 128
//   takes C = 1 and three stages, N = 256 a cluster of four.
//
// rls_fleet_kernel — the second stage of the two-stage route, for the shapes
//   the single pass does not take (N > 256, k > 64, N not a multiple of 4,
//   or a layout that does not fit in shared memory): the caller computes
//   PHt, G and W in torch, as the JAX wrapper does, and this pass computes
//   P' and beta', each P element read once and written once (one block per
//   (stream, 32-row tile), looping over 64-column tiles).
//
// P' and beta' go to separate buffers: the wrapper allocates them.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
// then W^T (m x N) | PHt rows (R x k) | S share (k x k) | S (k x k) | E (k x m).
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
    s_part = pht + R * k;
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

__global__ void __launch_bounds__(S_THREADS, 1)
    rls_single_kernel(const float* __restrict__ P, const float* __restrict__ beta,
                      const float* __restrict__ H, const float* __restrict__ Y,
                      float* __restrict__ p_out, float* __restrict__ beta_out, int S, int N,
                      int k, int m, int NS) {
  extern __shared__ __align__(128) unsigned char raw[];
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
  float y_next = (count > 0 && tid < km) ? Y[static_cast<size_t>(cid) * km + tid] : 0.0f;

  for (int i = 0; i < count; ++i) {
    const int st = i % NS;
    const size_t s = static_cast<size_t>(cid) + static_cast<size_t>(i) * n_clusters;
    float* p_s = sm + st * L.stage;
    float* hg = p_s + L.hg;
    const float* b_s = p_s + L.bs;
    const float y_cur = y_next;
    if (i + 1 < count && tid < km) y_next = Y[(s + n_clusters) * km + tid];
    mbar_wait(smem_addr(bars + st), (i / NS) & 1);

    if (rank1) {
      rank1_stream(p_s, hg, b_s, pht, e_s, y_cur, p_out, beta_out, s, N, m, warp, lane);
    } else {  // any k <= 64, clusters of 1, 2 or 4 blocks
      // 1. This block's rows of PHt = P H^T.
      float4* p4 = reinterpret_cast<float4*>(p_s);
      const float4* h4 = reinterpret_cast<const float4*>(hg);
      for (int q = 0; q < k; ++q) {
        float acc = 0.0f;
        if (has_row) {
          for (int it = 0, ci = first; it < nch; ++it, ci = ci + 1 == nch ? 0 : ci + 1) {
            const int c = ci * tpr + part;
            if (c >= n4) continue;
            const float4 a = p4[row * n4 + c], b = h4[q * n4 + c];
            acc = fmaf(a.x, b.x, acc);
            acc = fmaf(a.y, b.y, acc);
            acc = fmaf(a.z, b.z, acc);
            acc = fmaf(a.w, b.w, acc);
          }
        }
        for (int o = tpr / 2; o > 0; o >>= 1) acc += __shfl_xor_sync(0xFFFFFFFFu, acc, o);
        if (has_row && part == 0) pht[row * k + q] = acc;
      }
      if (tid < km) e_s[tid] = y_cur;
      for (int j = tid + S_THREADS; j < km; j += S_THREADS) e_s[j] = Y[s * km + j];
      __syncthreads();

      // 2. This block's share of S = I + H PHt (a sum over its rows), and
      //    E = Y - H beta, then W^T = (H^T E)^T.
      for (int pair = warp; pair < k * k; pair += S_WARPS) {
        const int q = pair / k, q2 = pair % k;
        float acc = 0.0f;
        for (int r = lane; r < R; r += 32) acc = fmaf(hg[q * N + r0 + r], pht[r * k + q2], acc);
        acc = warp_sum(acc);
        if (lane == 0) s_part[pair] = acc;
      }
      for (int pair = warp; pair < km; pair += S_WARPS) {
        const int q = pair / m, j = pair % m;
        float acc = 0.0f;
        for (int n = lane; n < N; n += 32) acc = fmaf(hg[q * N + n], b_s[n * m + j], acc);
        acc = warp_sum(acc);
        if (lane == 0) e_s[pair] -= acc;
      }
      __syncthreads();
      for (int j = tid; j < m * N; j += S_THREADS) {
        const int jj = j / N, n = j % N;
        float acc = 0.0f;
        for (int q = 0; q < k; ++q) acc = fmaf(hg[q * N + n], e_s[q * m + jj], acc);
        w_s[j] = acc;
      }

      // 3. Across the cluster: S = I + the sum of the shares, and the
      //    right-hand side PHt^T (k x N) over H, which no one reads any more.
      //    The second barrier also keeps the other blocks from overwriting
      //    their PHt and S share (next stream) before this block has read them.
      sync_cluster();
      for (int j = tid; j < k * k; j += S_THREADS) {
        float acc = 0.0f;
        for (int c = 0; c < C; ++c) acc += peer(s_part, c)[j];
        s_full[j] = (j / k == j % k ? 1.0f : 0.0f) + acc;
      }
      for (int j = tid; j < k * N; j += S_THREADS) {
        const int q = j / N, n = j % N, owner = n / R;
        hg[j] = peer(pht, owner)[(n - owner * R) * k + q];
      }
      sync_cluster();

      // 4. G = S^-1 PHt^T in place: Gauss-Jordan without pivoting (S is SPD).
      //    Columns of S left of the pivot are never read again, so each step
      //    updates only the columns right of it.
      for (int pv = 0; pv < k; ++pv) {
        const float d = s_full[pv * k + pv];  // never written below: the scaling starts right of it
        for (int j = pv + 1 + tid; j < k; j += S_THREADS) s_full[pv * k + j] /= d;
        for (int n = tid; n < N; n += S_THREADS) hg[pv * N + n] /= d;
        __syncthreads();
        for (int j = tid; j < (k - 1) * (k - pv); j += S_THREADS) {
          const int rw = j / (k - pv), col = pv + j % (k - pv);
          const int rr = rw < pv ? rw : rw + 1;  // every row but the pivot's
          if (col > pv) s_full[rr * k + col] -= s_full[rr * k + pv] * s_full[pv * k + col];
        }
        for (int j = tid; j < (k - 1) * N; j += S_THREADS) {
          const int rw = j / N, n = j % N;
          const int rr = rw < pv ? rw : rw + 1;
          hg[rr * N + n] -= s_full[rr * k + pv] * hg[pv * N + n];
        }
        __syncthreads();
      }

      // 5. One pass over this block's rows: P' = P - PHt G goes straight from
      //    registers to device memory (16-byte streaming stores), and its
      //    products with W^T accumulate beta' = beta + P' W, MMAX outputs per
      //    pass (P' is kept in shared memory only when m needs more passes).
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
                const float f = pht[row * k + q];
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
    if (tid == 0 && i + NS < count) fetch(i + NS);
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

}  // namespace

extern "C" int oselm_rls_single_smem_bytes(int N, int k, int m, int C, int NS) {
  return Layout(N, k, m, C, NS).bytes();
}

extern "C" int oselm_rls_single_launch(const void* P, const void* beta, const void* H,
                                       const void* Y, void* p_out, void* beta_out, int S, int N,
                                       int k, int m, int C, int NS, void* stream) {
  const int smem = Layout(N, k, m, C, NS).bytes();
  static int smem_set = 0;  // the largest opt-in so far
  cudaError_t err;
  if (smem > smem_set) {
    err = cudaFuncSetAttribute(rls_single_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = smem;
  }
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  // Persistent clusters, one block per SM, never more clusters than streams.
  const int clusters = max(1, min(S, sms / C));
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned int>(clusters * C));
  cfg.blockDim = dim3(S_THREADS);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned int>(C);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, rls_single_kernel, static_cast<const float*>(P),
                           static_cast<const float*>(beta), static_cast<const float*>(H),
                           static_cast<const float*>(Y), static_cast<float*>(p_out),
                           static_cast<float*>(beta_out), S, N, k, m, NS);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

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
