// The per-stream pass of the plan half of a tick, for Hopper (sm_90a).
//
// One kernel, plan_rows_kernel<KIND, MC>, computes everything engine/fleet.py's
// plan and gate do after the hidden projection, stream by stream:
//
//   1. the readout o = h . beta and pred = argmax(o) (the first maximum);
//   2. the top-2 values of o, once, giving the P1P2 confidence;
//   3. the drift detector's feature mean a = mean(|x|);
//   4. the drift score and drift.update (EWMA mean and variance, the
//      variance floor, the boot steps, the k-sigma test, the hysteresis);
//   5. algo1's rising-edge reset_phase;
//   6. should_query and theta_of;
//   7. the queried / controller / training masks of the mode;
//   8. the comm meter;
//   9. the ladder's skip-side pruning.update.
//
// KIND is the mode (algo1, serve, train_phase: gate is serve) or one of two
// reduced instantiations that stand alone: the readout only (o, any m >= 1)
// and the feature mean only (a).  MC is the readout's columns a pass: 8
// for m <= 8, else 16.  Its plain version is ref.plan_rows_ref
// (ref.readout_ref and ref.row_abs_mean_ref for the reduced ones).  None of
// this replaces a Pallas kernel: the reference computes it as XLA ops
// (repro/engine/fleet.py plan and gate).
//
// The cohort guarantee (engine/cohort.py) needs a row's arithmetic to be
// the same whatever S is, whatever the row's index and wherever its data
// lies: a member's row r sits at row i * width + r of the stacked buffers,
// so a path chosen by alignment would sum a row differently stacked and
// solo (x rows of n_in = 561 floats are 16-byte aligned only every fourth
// row).  So transfer and arithmetic are apart.  Each stream's beta block,
// h row and (where the detector reads features) x row are copied into shared
// memory by cp.async.bulk, each as the 16-byte-aligned span that encloses
// it, completing on an mbarrier (an x row too long for a stage, at a wide
// backbone's d_model, is read from device memory instead); the sums then
// run in one order fixed by (N, m, n_in) alone: lane l sums the terms l, l + 32,
// ... with fmaf (the readout) or in order (the feature mean), and a fixed
// xor butterfly adds the 32 partials.  The readout's m columns share one
// butterfly: at each of its first levels a lane keeps half of its columns
// and trades the other half with its partner, so each column's sum is the
// plain butterfly's, pair for pair, at a fraction of the shuffles.  The
// epilogue is one lane per stream, for a batch of 32 streams at a time,
// with the float steps written as the separately rounded operations torch
// runs (__fadd_rn and friends: nvcc would otherwise contract a multiply and
// an add into one fma), so its outputs equal the plain version's bit for
// bit when it is fed this kernel's o and a.
//
// What bounds it on this card: device memory.  At the fleet shape (S=16,384,
// N=128, m=6, n_in=561) a stream reads beta 3,072 B, h 512 B and x 2,244 B
// and about 70 B of state, and writes about 75 B.  Blocks of eight warps,
// persistent over a contiguous range of streams, each warp over a
// contiguous run of it; a warp keeps two streams' copies in flight, and its
// batch's state is loaded, one stream per lane, while the batch's rows are
// summed.  A first design with all of
// a stream's work on every lane (each lane ran the m butterflies, the top-2
// and the copies' bookkeeping) was bound by instruction issue, not memory,
// and reached half the bound; with the work per stream cut as above the
// pass runs at the rate of torch's batched readout, and more warps or
// stages in flight no longer move it (PERF.md).

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int MAX_STAGES = 2;
constexpr int MAX_M = 16;  // the fused kinds' largest m; columns are summed 8 or 16 a pass
constexpr int MAX_LADDER = 8;
constexpr int BAR_BYTES = WARPS * MAX_STAGES * 8;  // the mbarriers, ahead of the stages
constexpr int BULK_CHUNK = 32 * 1024;              // bytes per cp.async.bulk instruction
constexpr int SMEM_BUDGET = 200 * 1024;            // stages of one block, at most
constexpr int SMEM_MAX = 227 * 1024;               // what a block may opt in to

enum Kind : int { ALGO1 = 0, SERVE = 1, TRAIN_PHASE = 2, READOUT = 3, MEAN = 4, N_KINDS = 5 };

// The launch arguments arrive from the host as three arrays in this order
// (kernels/plan_rows.py holds the same names and checks them at load).
#define PLAN_ROWS_POINTERS(X)                                                                   \
  X(h) X(beta) X(x) X(count) X(level) X(streak) X(queries) X(skips) X(phase_trained) X(mean)    \
  X(var) X(steps) X(hits) X(calm) X(active) X(up_bytes) X(down_bytes) X(teacher_available)      \
  X(drift_active) X(outputs) X(pred) X(confidence) X(queried) X(controller_on) X(theta)         \
  X(mode_training) X(new_level) X(new_streak) X(new_queries) X(new_skips)                       \
  X(new_phase_trained) X(new_mean) X(new_var) X(new_steps) X(new_hits) X(new_calm)              \
  X(new_active) X(new_up_bytes) X(new_down_bytes) X(feature_mean)
#define PLAN_ROWS_INTS(X)                                                                       \
  X(S) X(N) X(m) X(n_in) X(use_features) X(use_confidence) X(prune_enabled) X(n_ladder)         \
  X(x_consec) X(min_trained) X(warmup) X(enter_hits) X(exit_calm)
#define PLAN_ROWS_FLOATS(X)                                                                     \
  X(k_sigma) X(decay) X(keep) X(up_per_query) X(down_per_query) X(ladder0) X(ladder1)           \
  X(ladder2) X(ladder3) X(ladder4) X(ladder5) X(ladder6) X(ladder7)

#define AS_INDEX(name) P_##name,
enum PointerIndex : int { PLAN_ROWS_POINTERS(AS_INDEX) N_POINTERS };
#undef AS_INDEX
#define AS_INDEX(name) I_##name,
enum IntIndex : int { PLAN_ROWS_INTS(AS_INDEX) N_INTS };
#undef AS_INDEX
#define AS_INDEX(name) F_##name,
enum FloatIndex : int { PLAN_ROWS_FLOATS(AS_INDEX) N_FLOATS };
#undef AS_INDEX

using u8 = unsigned char;  // torch.bool, one byte

struct Params {
  // Inputs: the rows, the state leaves, and two optional masks (null: all
  // available, no drift forced).
  const float *h, *beta, *x;
  const int *count, *level, *streak, *queries, *skips, *phase_trained;
  const float *mean, *var;
  const int *steps, *hits, *calm;
  const u8* active;
  const float *up_bytes, *down_bytes;
  const u8 *teacher_available, *drift_active;
  // Outputs: the plan's fields and the new leaves (new drift leaves null:
  // not written); feature_mean optional.
  float* outputs;
  int* pred;
  float* confidence;
  u8 *queried, *controller_on;
  float* theta;
  u8* mode_training;
  int *new_level, *new_streak, *new_queries, *new_skips, *new_phase_trained;
  float *new_mean, *new_var;
  int *new_steps, *new_hits, *new_calm;
  u8* new_active;
  float *new_up_bytes, *new_down_bytes, *feature_mean;
  long long S;
  int N, m, n_in;
  int use_features, use_confidence, prune_enabled, n_ladder, x_consec, min_trained, warmup,
      enter_hits, exit_calm;
  float k_sigma, decay, keep, up_per_query, down_per_query;
  float ladder[MAX_LADDER];
  // One stage (a stream's copies) of a warp, in floats: beta at 0, h at
  // off_h, x at off_x; the number of stages per warp.
  int off_h, off_x, stage_floats, stages;
  int scratch_floats;  // the fused kinds' per-block scratch, after the stages
  // stage_x: the x row is copied into the stage; false where a stream's x
  // row does not fit one (the warp then reads it from device memory).
  bool reads_rows, reads_x, stage_x;
};

__host__ __device__ constexpr int span_floats(int n) {
  // A span of n floats copied as the 16-byte-aligned span enclosing it.
  return ((n + 3) / 4) * 4 + 4;
}

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
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2, %3;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(phase), "r"(0x989680u)  // suspend up to 10 ms a poll
        : "memory");
  } while (!done);
}

// The 16-byte-aligned span that encloses n floats at src: (its start, bytes).
__device__ __forceinline__ uint32_t span_bytes(const float* src, int n, const char** start) {
  const uintptr_t p = reinterpret_cast<uintptr_t>(src);
  const uintptr_t a0 = p & ~static_cast<uintptr_t>(15);
  const uintptr_t a1 = (p + 4 * static_cast<uintptr_t>(n) + 15) & ~static_cast<uintptr_t>(15);
  *start = reinterpret_cast<const char*>(a0);
  return static_cast<uint32_t>(a1 - a0);
}

// Where the n floats at src begin inside their copied span.
__device__ __forceinline__ const float* in_span(const float* stage_part, const float* src) {
  return stage_part + ((reinterpret_cast<uintptr_t>(src) & 15) >> 2);
}

__device__ __forceinline__ void bulk_load(float* dst, const char* src, uint32_t bytes,
                                          uint32_t bar) {
  for (uint32_t off = 0; off < bytes; off += BULK_CHUNK) {
    const uint32_t n = min(static_cast<uint32_t>(BULK_CHUNK), bytes - off);
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
            "r"(smem_addr(dst) + off),
        "l"(src + off), "r"(n), "r"(bar)
        : "memory");
  }
}

// torch's float comparisons for argmax and topk: NaN above everything.
__device__ __forceinline__ bool above(float a, float b) {
  return a > b || (isnan(a) && !isnan(b));
}

// The argmax (first maximum) and the top-2 values of o[0..m), 2 <= m <= MC.
template <int MC>
__device__ __forceinline__ void top2(const float (&o)[MC], int m, float& t0, float& t1,
                                     int& best) {
  t0 = o[0];
  t1 = __int_as_float(0xff800000);  // -inf
  best = 0;
#pragma unroll
  for (int j = 1; j < MC; ++j) {
    if (j < m) {
      if (above(o[j], t0)) {
        t1 = t0;
        t0 = o[j];
        best = j;
      } else if (above(o[j], t1)) {
        t1 = o[j];
      }
    }
  }
}

// The xor butterfly over the warp of each of MC columns (MC a power of two,
// at most 32), with the work halved at each of the first log2(MC) levels: a
// lane keeps half of its columns and sends its partner the other half.
// Every column's sum is the plain butterfly's, pair for pair (lane l adds
// lane l ^ off's value of the same column at every level); it ends on the
// 32 / MC lanes from lane col * 32 / MC, in acc[0].
template <int MC>
__device__ __forceinline__ float reduce_columns(float (&acc)[MC], int lane) {
  static_assert(MC >= 1 && MC <= 32 && (MC & (MC - 1)) == 0, "MC: a power of two <= 32");
  constexpr int LOG2_MC = MC >= 32 ? 5 : MC >= 16 ? 4 : MC >= 8 ? 3 : MC >= 4 ? 2 : MC >= 2 ? 1 : 0;
#pragma unroll
  for (int level = 0; level < LOG2_MC; ++level) {
    const int off = 16 >> level;
    const int half = MC >> (level + 1);
    const bool upper = (lane & off) != 0;
#pragma unroll
    for (int c = 0; c < MC / 2; ++c) {
      if (c < half) {
        const float send = upper ? acc[c] : acc[c + half];
        const float mine = upper ? acc[c + half] : acc[c];
        acc[c] = mine + __shfl_xor_sync(0xFFFFFFFFu, send, off);
      }
    }
  }
#pragma unroll
  for (int off = 16 >> LOG2_MC; off > 0; off >>= 1)
    acc[0] += __shfl_xor_sync(0xFFFFFFFFu, acc[0], off);
  return acc[0];
}

// torch.clamp / clamp_min / maximum on floats: a NaN operand comes out.
__device__ __forceinline__ float clamp_nan(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ float clamp_min_nan(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float maximum_nan(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}

__device__ __forceinline__ int add1(int v) {  // int32 + 1, wrapping as torch's
  return static_cast<int>(static_cast<unsigned int>(v) + 1u);
}

// One stream's state, held by its epilogue lane from the start of its batch.
struct Row {
  int count, level, streak, queries, skips, phase_trained, steps, hits, calm;
  float mean, var, up, down;
  bool active, available, forced;
};

template <int KIND>
__device__ __forceinline__ void load_row(const Params& p, long long s, Row& r) {
  r.count = p.count[s];
  r.level = p.level[s];
  r.streak = p.streak[s];
  r.queries = p.queries[s];
  r.skips = p.skips[s];
  r.phase_trained = p.phase_trained[s];
  r.mean = p.mean[s];
  r.var = p.var[s];
  r.steps = p.steps[s];
  r.hits = p.hits[s];
  r.calm = p.calm[s];
  r.active = p.active[s] != 0;
  r.up = p.up_bytes[s];
  r.down = p.down_bytes[s];
  r.available = p.teacher_available == nullptr || p.teacher_available[s] != 0;
  r.forced = KIND == TRAIN_PHASE && p.drift_active != nullptr && p.drift_active[s] != 0;
}

// Steps 2-9 for one stream, from its o's top-2 (t0, t1), argmax and feature
// mean a.  Each float step is the one torch op of the plain version.
template <int KIND>
__device__ __forceinline__ void epilogue(const Params& p, long long s, const Row& r, float t0,
                                         float t1, int best, float a) {
  const float diff = __fsub_rn(t0, t1);
  const float conf = clamp_nan(diff, 0.0f, 1.0f);  // pruning.confidence

  // drift.score and drift.update (algo1, serve); train_phase keeps the state.
  float mean = r.mean, var = r.var;
  int steps = r.steps, hits = r.hits, calm = r.calm;
  bool active = r.active;
  if (KIND != TRAIN_PHASE) {
    // torch.stack(parts).mean(0): the sum from 0, times 1 / len(parts).
    float sum = 0.0f;
    if (p.use_features) sum = __fadd_rn(sum, a);
    if (p.use_confidence) sum = __fadd_rn(sum, -diff);
    const float score = __fmul_rn(sum, (p.use_features && p.use_confidence) ? 0.5f : 1.0f);
    const float d = __fsub_rn(score, r.mean);
    const float floor_root = __fmul_rn(fabsf(r.mean), static_cast<float>(1e-3));
    const float var_floor = __fadd_rn(__fmul_rn(floor_root, floor_root), static_cast<float>(1e-12));
    const float std = __fsqrt_rn(maximum_nan(r.var, var_floor));
    const bool armed = r.steps >= p.warmup;
    const bool outlier = armed && fabsf(d) > __fmul_rn(std, p.k_sigma);
    const float dd = __fmul_rn(d, d);
    if (!outlier) {
      mean = __fadd_rn(__fmul_rn(r.mean, p.decay), __fmul_rn(score, p.keep));
      var = __fadd_rn(__fmul_rn(r.var, p.decay), __fmul_rn(dd, p.keep));
    }
    if (r.steps < 8) {
      const float steps_f = __int2float_rn(r.steps);
      const float next = __fadd_rn(steps_f, 1.0f);
      mean = __fdiv_rn(__fadd_rn(__fmul_rn(r.mean, steps_f), score), next);
      var = clamp_min_nan(__fdiv_rn(__fadd_rn(__fmul_rn(r.var, steps_f), dd), next),
                          static_cast<float>(1e-9));
    }
    hits = outlier ? add1(r.hits) : 0;
    calm = outlier ? 0 : add1(r.calm);
    const bool enter = hits >= p.enter_hits;
    const bool leave = calm >= p.exit_calm;
    active = r.active ? !leave : enter;
    steps = add1(r.steps);
    if (enter) hits = 0;
    if (leave) calm = 0;
  }

  // The mode's masks; algo1 re-arms the phase counter on the rising edge.
  const bool training = KIND == ALGO1 ? active : true;
  const int phase_trained = (KIND == ALGO1 && training && !r.active) ? 0 : r.phase_trained;
  const int level_c = min(max(r.level, 0), p.n_ladder - 1);
  float theta = p.ladder[0];  // theta_of's selects
#pragma unroll
  for (int i = 1; i < MAX_LADDER; ++i)
    if (level_c == i) theta = p.ladder[i];
  const bool high = conf > theta;
  bool want = true;  // should_query
  if (p.prune_enabled) {
    const bool drifting = KIND == SERVE ? active : r.forced;
    want = !(r.count >= p.min_trained && !drifting && high);
  }
  const bool queried = (KIND == ALGO1 ? training : true) && want && r.available;
  const bool controller_on = (KIND == ALGO1 ? training : true) && r.available;

  // The meter charges every issued query.
  const float q = queried ? 1.0f : 0.0f;
  p.new_up_bytes[s] = __fadd_rn(r.up, __fmul_rn(q, p.up_per_query));
  p.new_down_bytes[s] = __fadd_rn(r.down, __fmul_rn(q, p.down_per_query));

  // A skipped sample's ladder step: success iff conf > theta, no mismatch.
  int level = r.level, streak = r.streak, skips = r.skips;
  if (controller_on && !queried) {
    streak = high ? add1(r.streak) : 0;
    if (streak >= p.x_consec) {
      level = min(add1(r.level), p.n_ladder - 1);
      streak = 0;
    }
    skips = add1(r.skips);
  }

  p.pred[s] = best;
  p.confidence[s] = conf;
  p.queried[s] = queried;
  p.controller_on[s] = controller_on;
  p.theta[s] = theta;
  p.mode_training[s] = training;
  p.new_level[s] = level;
  p.new_streak[s] = streak;
  p.new_queries[s] = r.queries;
  p.new_skips[s] = skips;
  p.new_phase_trained[s] = phase_trained;
  if (p.new_mean != nullptr) {
    p.new_mean[s] = mean;
    p.new_var[s] = var;
    p.new_steps[s] = steps;
    p.new_hits[s] = hits;
    p.new_calm[s] = calm;
    p.new_active[s] = active;
  }
}

template <int KIND, int MC>
__global__ void __launch_bounds__(THREADS) plan_rows_kernel(const Params p) {
  constexpr bool FUSED = KIND <= TRAIN_PHASE;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem) + warp * MAX_STAGES;
  float* stages = reinterpret_cast<float*>(smem + BAR_BYTES) + warp * p.stages * p.stage_floats;
  // The fused kinds' per-warp scratch, after all stages: each stream of a
  // batch's o (MC floats) and feature mean, for its epilogue lane.
  float* o_s = reinterpret_cast<float*>(smem + BAR_BYTES) + WARPS * p.stages * p.stage_floats +
               warp * 32 * (MC + 1);
  float* a_s = o_s + 32 * MC;

  // This block's contiguous range of streams, cut into one contiguous run
  // per warp (so a batch's state is read and written 32 streams in a row).
  const long long lo = p.S * blockIdx.x / gridDim.x;
  const long long hi = p.S * (blockIdx.x + 1) / gridDim.x;
  const long long chunk = (hi - lo + WARPS - 1) / WARPS;
  const long long first = lo + warp * chunk;
  const int count = first < hi ? static_cast<int>(hi - first < chunk ? hi - first : chunk) : 0;
  if (count == 0) return;
  const int NS = p.stages, N = p.N, m = p.m, n_in = p.n_in;
  auto stream_of = [&](int i) { return first + i; };
  constexpr int LPC = 32 / MC;  // lanes that end with one column's sum
  const int col = lane / LPC;

  // The i-th stream's spans into stage i % NS: lane 0 copies beta, lane 1
  // h, lane 2 x (where staged), each arriving on the stage's barrier with
  // its bytes.
  const int copiers = (p.reads_rows ? 2 : 0) + (p.stage_x ? 1 : 0);
  auto fetch = [&](int i) {
    const long long s = stream_of(i);
    const uint32_t bar = smem_addr(bars + i % NS);
    const bool copies = lane < 2 ? p.reads_rows : (lane == 2 && p.stage_x);
    const char* start = nullptr;
    uint32_t bytes = 0;
    float* dst = stages + (i % NS) * p.stage_floats;
    if (copies) {
      if (lane == 0) {
        bytes = span_bytes(p.beta + s * N * m, N * m, &start);
      } else if (lane == 1) {
        bytes = span_bytes(p.h + s * N, N, &start);
        dst += p.off_h;
      } else {
        bytes = span_bytes(p.x + s * n_in, n_in, &start);
        dst += p.off_x;
      }
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
                   "r"(bytes)
                   : "memory");
      bulk_load(dst, start, bytes, bar);
    }
  };

  if (lane == 0) {
    for (int st = 0; st < NS; ++st)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bars + st)),
                   "r"(copiers)
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncwarp();
  for (int i = 0; i < min(NS, count); ++i) fetch(i);

  for (int b0 = 0; b0 < count; b0 += 32) {
    const int nb = min(32, count - b0);
    // The batch's state, one stream per lane, loaded while its rows are summed.
    Row row;
    if constexpr (FUSED) {
      if (lane < nb) load_row<KIND>(p, stream_of(b0 + lane), row);
    }

    for (int k = 0; k < nb; ++k) {
      const int i = b0 + k;
      const long long s = stream_of(i);
      const float* stage = stages + (i % NS) * p.stage_floats;
      mbar_wait(smem_addr(bars + i % NS), static_cast<uint32_t>((i / NS) & 1));

      float a = 0.0f;
      if (p.reads_x) {
        // Staged or not, lane l sums the terms l, l + 32, ... in order.
        const float* xg = p.x + s * n_in;
        const float* xs = p.stage_x ? in_span(stage + p.off_x, xg) : xg;
        for (int j = lane; j < n_in; j += 32) a = __fadd_rn(a, fabsf(xs[j]));
      }
      float acc[MC];
      // The readout, MC columns a pass: lane l sums rows l, l + 32, ...
      const float* bs = in_span(stage, p.beta + s * N * m);
      const float* hs = in_span(stage + p.off_h, p.h + s * N);
      for (int j0 = 0; j0 < (p.reads_rows ? m : 0); j0 += MC) {
#pragma unroll
        for (int j = 0; j < MC; ++j) acc[j] = 0.0f;
        for (int n = lane; n < N; n += 32) {
          const float hv = hs[n];
          const float* brow = bs + n * m + j0;
#pragma unroll
          for (int j = 0; j < MC; ++j)
            if (j0 + j < m) acc[j] = fmaf(hv, brow[j], acc[j]);
        }
        if (KIND == READOUT) {  // more passes may follow: the stage is still read
          const float o = reduce_columns<MC>(acc, lane);
          if (lane % LPC == 0 && j0 + col < m) p.outputs[s * m + j0 + col] = o;
        }
      }
      // The stage is read: it takes the stream NS ahead.
      __syncwarp();
      if (lane < 3) asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      if (i + NS < count) fetch(i + NS);

      if constexpr (FUSED) {
        const float o = reduce_columns<MC>(acc, lane);
        if (lane % LPC == 0 && col < m) {
          p.outputs[s * m + col] = o;
          o_s[k * MC + col] = o;
        }
      }
      if (p.reads_x) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) a += __shfl_xor_sync(0xFFFFFFFFu, a, off);
        a = __fdiv_rn(a, static_cast<float>(n_in));
        if (lane == 0) {
          if (p.feature_mean != nullptr) p.feature_mean[s] = a;
          if (FUSED) a_s[k] = a;
        }
      }
    }
    if constexpr (FUSED) {
      __syncwarp();  // the batch's o and a are in the scratch
      if (lane < nb) {
        float o[MC];
#pragma unroll
        for (int j = 0; j < MC; ++j) o[j] = j < m ? o_s[lane * MC + j] : 0.0f;
        float t0, t1;
        int best;
        top2<MC>(o, m, t0, t1, best);
        epilogue<KIND>(p, stream_of(b0 + lane), row, t0, t1, best, p.reads_x ? a_s[lane] : 0.0f);
      }
      __syncwarp();  // before the next batch rewrites the scratch
    }
  }
}

using KernelFn = void (*)(const Params);
// By kind, then by columns a pass: 8 (m <= 8) or 16.
const KernelFn KERNELS[N_KINDS][2] = {
    {plan_rows_kernel<ALGO1, 8>, plan_rows_kernel<ALGO1, 16>},
    {plan_rows_kernel<SERVE, 8>, plan_rows_kernel<SERVE, 16>},
    {plan_rows_kernel<TRAIN_PHASE, 8>, plan_rows_kernel<TRAIN_PHASE, 16>},
    {plan_rows_kernel<READOUT, 8>, plan_rows_kernel<READOUT, 16>},
    {plan_rows_kernel<MEAN, 8>, plan_rows_kernel<MEAN, 8>},
};

int columns_per_pass(int m) { return m <= 8 ? 8 : 16; }

// The stage layout and the stages per warp of a launch; false where one
// stage per warp does not fit in a block's shared memory.  A fused kind
// whose x row does not fit a stage (n_in above about 6,000 floats at N=128,
// m=6: the widest dense backbones) leaves x out of the stage and reads it
// from device memory in the same order, so its sums are unchanged.
bool layout(Params& p, int kind) {
  p.reads_rows = kind != MEAN;
  p.reads_x = kind == MEAN || ((kind == ALGO1 || kind == SERVE) && p.use_features);
  p.scratch_floats = kind <= TRAIN_PHASE ? WARPS * 32 * (columns_per_pass(p.m) + 1) : 0;
  for (p.stage_x = p.reads_x;; p.stage_x = false) {
    p.off_h = p.reads_rows ? span_floats(p.N * p.m) : 0;
    p.off_x = p.off_h + (p.reads_rows ? span_floats(p.N) : 0);
    p.stage_floats = p.off_x + (p.stage_x ? span_floats(p.n_in) : 0);
    const long long stage_bytes = 4LL * p.stage_floats;
    p.stages = MAX_STAGES;
    while (p.stages > 1 &&
           BAR_BYTES + WARPS * p.stages * stage_bytes + 4LL * p.scratch_floats > SMEM_BUDGET)
      --p.stages;
    if (BAR_BYTES + WARPS * p.stages * stage_bytes + 4LL * p.scratch_floats <= SMEM_MAX)
      return true;
    // The feature mean alone has nothing else to stage: it takes n_in as
    // far as its stage fits.
    if (!p.stage_x || !p.reads_rows) return false;
  }
}

int smem_bytes(const Params& p) {
  return BAR_BYTES + 4 * (WARPS * p.stages * p.stage_floats + p.scratch_floats);
}

// The launch's Params from the host's three arrays; false where the shape
// does not fit or there is no stream.
bool unpack(Params& p, int kind, const void* const* ptrs, const int* ints, const float* floats) {
#define SET(name) p.name = static_cast<decltype(p.name)>(const_cast<void*>(ptrs[P_##name]));
  PLAN_ROWS_POINTERS(SET)
#undef SET
  p.S = ints[I_S];
  p.N = ints[I_N];
  p.m = ints[I_m];
  p.n_in = ints[I_n_in];
  p.use_features = ints[I_use_features];
  p.use_confidence = ints[I_use_confidence];
  p.prune_enabled = ints[I_prune_enabled];
  p.n_ladder = ints[I_n_ladder];
  p.x_consec = ints[I_x_consec];
  p.min_trained = ints[I_min_trained];
  p.warmup = ints[I_warmup];
  p.enter_hits = ints[I_enter_hits];
  p.exit_calm = ints[I_exit_calm];
  p.k_sigma = floats[F_k_sigma];
  p.decay = floats[F_decay];
  p.keep = floats[F_keep];
  p.up_per_query = floats[F_up_per_query];
  p.down_per_query = floats[F_down_per_query];
  for (int i = 0; i < MAX_LADDER; ++i) p.ladder[i] = floats[F_ladder0 + i];
  return layout(p, kind) && p.S > 0;
}

}  // namespace

// Names of the three argument arrays, comma-separated, in their order.
#define AS_NAME(name) #name ","
extern "C" const char* plan_rows_pointer_names() { return PLAN_ROWS_POINTERS(AS_NAME); }
extern "C" const char* plan_rows_int_names() { return PLAN_ROWS_INTS(AS_NAME); }
extern "C" const char* plan_rows_float_names() { return PLAN_ROWS_FLOATS(AS_NAME); }
#undef AS_NAME

// Shared memory a launch of this kind and shape takes, or -1 where it does
// not fit (the wrapper raises).
extern "C" int plan_rows_smem_bytes(int kind, int N, int m, int n_in, int use_features) {
  Params p = {};
  p.N = N;
  p.m = m;
  p.n_in = n_in;
  p.use_features = use_features;
  return (kind >= 0 && kind < N_KINDS && layout(p, kind)) ? smem_bytes(p) : -1;
}

extern "C" int plan_rows_launch(int kind, const void* const* ptrs, const int* ints,
                                const float* floats, void* stream) {
  Params p = {};
  if (kind < 0 || kind >= N_KINDS || !unpack(p, kind, ptrs, ints, floats)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = smem_bytes(p);

  static int smem_set[N_KINDS][2] = {};  // the largest opt-in so far, per kernel
  cudaError_t err;
  const int wide = columns_per_pass(p.m) == 16;
  const KernelFn kernel = KERNELS[kind][wide];
  if (smem > 48 * 1024 && smem > smem_set[kind][wide]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set[kind][wide] = smem;
  }
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  // Persistent blocks: as many as fit on the card at once (at most four an
  // SM, each SM keeps 1 KB a block), never more than a block per WARPS streams.
  const int per_sm = std::max(1, std::min(4, (228 * 1024) / (smem + 1024)));
  const long long resident = static_cast<long long>(sms) * per_sm;
  const unsigned int blocks =
      static_cast<unsigned int>(std::max(1LL, std::min((p.S + WARPS - 1) / WARPS, resident)));
  kernel<<<blocks, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* plan_rows_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
