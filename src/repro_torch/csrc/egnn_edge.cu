// Fused EGNN edge message + aggregation, forward, fp32 or bf16 compute,
// deterministic.
//
// Replaces the Pallas TPU kernel `egnn_edge_fused` (_edge_kernel) of
// src/repro/kernels/egnn_edge/kernel.py, which computes per graph b
//
//   agg[b,a] = sum_{e: dst=a, dst<A} silu(h[src]·w0i + h[dst]·w0j
//                                        + d2_e·w0d + b0)·w1 + b1
//
// with the gathers clamped to A-1 and every edge with dst >= A (masked or
// pad) contributing exactly nothing. The TPU kernel keeps a resident (A,H)
// f32 node accumulator across a sequential grid; at A=64, H=866 that alone
// is 221,696 bytes, which cannot sit beside anything else in the 227 KB of
// shared memory a Hopper block may use, and Hopper blocks run in no order.
//
// Algebra: both dense layers of φ_e are linear in what they read, so the
// edge-major work reduces to an elementwise map plus a segment-sum:
//
//   Pi = h·w0i + b0,  Pj = h·w0j                       (B·A x H each)
//   s_e = silu(Pi[src_e] + Pj[dst_e] + d2_e·w0d)
//   S[b,a] = sum_{e->a} s_e,  deg[b,a] = number of such edges
//   agg = S·w1 + deg ⊗ b1
//
// This is exact algebra (h[src]·w0i == (h·w0i)[src]; sum_e (s_e·w1 + b1)
// == (sum_e s_e)·w1 + deg·b1); only the fp32 summation order differs from
// the reference. Nothing edge-major reaches device memory: the scratch is
// node-major (Pi, Pj, S: B·A·H f32 each, deg B·A), and the backward
// (csrc/egnn_edge_bwd.cu) reads it.
//
// Bound, at the training path's shape (B=40, A=64, E=2048, H=866, ~68.5k
// valid edges): the three products do 3·2·B·A·H² = 11.5 GFLOP, the edge
// walk ~8 operations per valid edge and column (0.47 GFLOP). As three TF32
// tensor-core products (495 TFLOP/s) plus the walk at the 67 TFLOP/s fp32
// peak that is ~0.077 ms; all in fp32 FFMA ~0.179 ms; the ~39 MB the call
// must move take ~0.012 ms. Operations bound it. In bf16 the products run
// once each at the bf16 tensor-core peak (989 TFLOP/s), the walk as
// before: ~0.019 ms.
//
// A call is at most 4 kernels, 3 when fc1 is not split:
//   1. gemm_tc (csrc/gemm_tc.cuh, NN layout): Pi and Pj on the tensor cores
//      at fp32 accuracy (3xTF32, the accumulator folded into an f32 sum
//      every 64 k). With `proj_splits` > 1 each is cut into that many
//      k-ranges, written as partials; else Pi gets b0 in the epilogue;
//   2. the edge kernel: one CTA per (column tile of block_h, graph) sums
//      Pi's and Pj's partials in split order (adding b0) as it stages the
//      graph's column tiles, writes Pi and Pj for the backward, compacts
//      the graph's edges into per-destination lists in edge order
//      (csrc/edge_lists.cuh), and the warp that owns node a walks a's list
//      — Pj[a] in a register, Pi[src] from shared memory, 4 listed edges
//      computed at once without branches — summing S[a] in a register and
//      writing it once; deg[a] is the list's length;
//   3. gemm_tc: agg = S·w1, with deg[r]·b1[c] added in the epilogue (one
//      fma) or, with `fc1_splits` > 1, its partials;
//   4. only when fc1 is split: gemm_tc's reduce items sum agg's partials in
//      split order and add deg[r]·b1[c].
// kernels/egnn_edge/gemm_plan.py plans both split counts from (B, A, H)
// alone, with a greedy-schedule makespan model of the card's dispatch.
//
// Determinism: no atomics anywhere. S[a] sums a's edges in edge order
// alone (block_e and block_h change no bit of it), each product sums its
// k-steps in order, then its splits in order; every order depends on the
// shapes and the plan alone, so a graph's rows are the same bits wherever
// it sits in a batch of the same shape, and two calls agree bit for bit.
//
// Shapes every tile fits: a graph's edges are walked in windows of
// block_e (one window when its list fits), S[a] and deg[a] carried from
// window to window through global memory in f32 (the same sums in the same
// order); the column tiles are staged only when they fit beside the
// window (STAGED), else read from global memory.
//
// sigmoid is 1 / (1 + 2^(-z·log2 e)) through the SFU (__expf, __fdividef):
// a few ulp from expf, far inside the forward's 1e-4 tolerance.
//
// bf16 compute (egnn_edge_fwd_bf16_launch): h and the φ_e weights arrive in
// bf16 (the wrapper casts the leaves as repro's _split_phi_e does, biases
// included) and the three products run on bf16 tensor cores
// (csrc/gemm_bf16.cuh: wgmma k16, f32 accumulators, no split). Where it
// rounds: Pi and Pj are f32 sums of bf16 products (+ b0 in f32), the edge
// kernel runs unchanged in f32 on them (z, d² and silu in f32, S summed in
// f32), fc1 reads S rounded once to bf16, and out is rounded once to bf16.
// repro's Pallas kernel (kernel.py:118-145) rounds z and d² to bf16 per edge
// and feeds silu(z) in bf16 to fc1 per edge, then sums the f32 messages;
// tests/test_torch_bf16.py bounds the whole difference on the CPU.
#include "common.cuh"
#include "edge_lists.cuh"
#include "gemm_bf16.cuh"
#include "gemm_tc.cuh"

constexpr int EF_WARPS = 8;            // warps of the edge kernel
constexpr int EF_THREADS = 32 * EF_WARPS;
constexpr int EU = 4;                  // listed edges in flight a warp
constexpr size_t kEdgeSmemBudget = 231424;   // budget.SMEM_BUDGET
constexpr int FWD_REDUCE_ELEMS = 4096;       // gemm_plan.FWD_REDUCE_ELEMS

// Dynamic shared memory of the edge kernel (bytes): a window of block_e
// listed edges (src, d²), per-warp counts, list offsets and node positions
// (48·A + 4), and the Pi and Pj column tiles when `staged`. Kept equal to
// budget.smem_bytes.
static inline size_t edge_fwd_smem(int A, int be, int bh, bool staged) {
  return (size_t)8 * be + (size_t)48 * A + 4 +
         (staged ? (size_t)8 * A * bh : 0);
}

// ---------------------------------------------------------------------------
// Edge kernel: one CTA per (column tile of block_h, graph). Its 8 warps are
// block_h/32 column groups (32 columns a warp, a lane a column) times
// 8/(block_h/32) node groups: node group q owns the nodes q, q + groups, ...
// `part` holds Pi's then Pj's `psplits` partials (psplits > 1), else Pi and
// Pj are final. Pi, Pj, S and deg are not restrict: the unstaged variant
// reads back the Pi and Pj tiles its CTA wrote, and a window reads the
// S and deg the previous window wrote.
// ---------------------------------------------------------------------------
template <bool STAGED, typename WT>
__global__ void __launch_bounds__(EF_THREADS, 4)
egnn_edge_fwd_kernel(const float* __restrict__ part, int psplits,
                     const float* __restrict__ b0, float* Pi, float* Pj,
                     const float* __restrict__ pos,
                     const int32_t* __restrict__ src,
                     const int32_t* __restrict__ dst,
                     const WT* __restrict__ w0d, float* S, float* deg,
                     int A, int E, int H, int bh, int block_e) {
  extern __shared__ __align__(16) unsigned char ef_smem[];
  int2* list = reinterpret_cast<int2*>(ef_smem);        // [block_e] (s, d²)
  float* tiles = reinterpret_cast<float*>(list + block_e);  // [2][A][bh]
  int* cnt = reinterpret_cast<int*>(tiles + (STAGED ? 2 * A * bh : 0));
  int* off = cnt + EF_WARPS * A;                        // [A + 1]
  float* pos_s = reinterpret_cast<float*>(off + A + 1);  // [A][3]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y;
  const int ncg = bh / 32, nng = EF_WARPS / ncg;
  const int cg = warp % ncg, ng = warp / ncg;
  const bool owner = ng < nng;          // a warp past ncg x nng only helps
  const int c0 = blockIdx.x * bh;       // the tile's first column
  const int cc = cg * 32 + lane;        // this lane's column in the tile
  const int c = c0 + cc;
  const bool active = owner && c < H;
  const bool counter = owner && blockIdx.x == 0 && cg == 0 && lane == 0;
  const float wd = active ? to_f32(w0d[c]) : 0.f;
  const size_t node0 = (size_t)b * A * H;
  const size_t MH = (size_t)gridDim.y * A * H;    // one partial
  const int32_t* sr = src + (size_t)b * E;
  const int32_t* dr = dst + (size_t)b * E;

  // Pi and Pj of the tile: partials summed in split order (+ b0) and
  // written for the backward, staged when they fit
  if (STAGED || psplits > 1) {
    for (int idx = tid; idx < A * bh; idx += EF_THREADS) {
      const int a = idx / bh, col = c0 + idx - a * bh;
      float vi = 0.f, vj = 0.f;
      if (col < H) {
        const size_t g = node0 + (size_t)a * H + col;
        if (psplits > 1) {
          const float* pj_part = part + (size_t)psplits * MH;
          vi = part[g];
          vj = pj_part[g];
          for (int s = 1; s < psplits; ++s) {
            vi += part[s * MH + g];
            vj += pj_part[s * MH + g];
          }
          vi += b0[col];
          Pi[g] = vi;
          Pj[g] = vj;
        } else {
          vi = Pi[g];
          vj = Pj[g];
        }
      }
      if (STAGED) {
        tiles[idx] = vi;
        tiles[A * bh + idx] = vj;
      }
    }
  }
  for (int i = tid; i < 3 * A; i += EF_THREADS)
    pos_s[i] = pos[(size_t)b * A * 3 + i];

  // node a's value in this lane's column: row a of a tile
  const float* pi_t = STAGED ? tiles : Pi + node0 + c0;
  const float* pj_t = STAGED ? tiles + A * bh : Pj + node0 + c0;
  const int ldt = STAGED ? bh : H;
  const int col = active ? cc : 0;      // inactive lanes read a valid cell
  const unsigned lt = (1u << lane) - 1;

  // one window when the graph's list fits; E = 0 still writes S and deg
  for (int w0 = 0; w0 == 0 || w0 < E; w0 += block_e) {
    const int ne = max(0, min(block_e, E - w0));
    for (int a = lane; a < A; a += 32) cnt[warp * A + a] = 0;
    __syncthreads();                    // tiles staged; last window walked

    // each warp counts its contiguous share of the window's 32-edge chunks
    // per destination (an edge with dst out of range is in no list)
    const int nch = (ne + 31) / 32, cpw = (nch + EF_WARPS - 1) / EF_WARPS;
    const int ch0 = min(nch, warp * cpw), ch1 = min(nch, ch0 + cpw);
    for (int ch = ch0; ch < ch1; ch += 8) {
      int kd[8], ks[8];
      chunk_keys(dr + w0, sr + w0, A, ne, ch, ch1, kd, ks);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const unsigned md = __match_any_sync(FULL, kd[j]);
        if (kd[j] >= 0 && (md & lt) == 0) cnt[warp * A + kd[j]] += __popc(md);
        __syncwarp();
      }
    }
    __syncthreads();
    if (warp == 0) list_offsets<EF_WARPS>(cnt, off, A);
    __syncthreads();

    // the same walk again places each edge with its d²: lists in edge order
    for (int ch = ch0; ch < ch1; ch += 8) {
      int kd[8], ks[8];
      chunk_keys(dr + w0, sr + w0, A, ne, ch, ch1, kd, ks);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const unsigned md = __match_any_sync(FULL, kd[j]);
        if (kd[j] >= 0) {
          const float ex = pos_s[ks[j] * 3 + 0] - pos_s[kd[j] * 3 + 0];
          const float ey = pos_s[ks[j] * 3 + 1] - pos_s[kd[j] * 3 + 1];
          const float ez = pos_s[ks[j] * 3 + 2] - pos_s[kd[j] * 3 + 2];
          list[cnt[warp * A + kd[j]] + __popc(md & lt)] =
              make_int2(ks[j], __float_as_int(ex * ex + ey * ey + ez * ez));
        }
        __syncwarp();
        if (kd[j] >= 0 && (md & lt) == 0) cnt[warp * A + kd[j]] += __popc(md);
        __syncwarp();
      }
    }
    __syncthreads();

    for (int a = ng; owner && a < A; a += nng) {
      const int lo = off[a], hi = off[a + 1];
      const size_t o = node0 + (size_t)a * H + c;
      const float pj = active ? pj_t[a * ldt + col] : 0.f;
      float acc = w0 > 0 && active ? S[o] : 0.f;
      for (int q = lo; q < hi; q += EU) {
        float v[EU];
#pragma unroll
        for (int u = 0; u < EU; ++u) {   // EU listed edges in flight
          const int2 ent = list[min(q + u, hi - 1)];
          const float z = pi_t[ent.x * ldt + col] + pj +
                          __int_as_float(ent.y) * wd;
          v[u] = z * __fdividef(1.f, 1.f + __expf(-z));
        }
#pragma unroll
        for (int u = 0; u < EU; ++u) {   // then the sum, in list order
          if (q + u >= hi) break;        // the same for the whole warp
          acc += v[u];
        }
      }
      if (active) S[o] = acc;
      if (counter)
        deg[(size_t)b * A + a] =
            (w0 > 0 ? deg[(size_t)b * A + a] : 0.f) + (float)(hi - lo);
    }
  }
}

// The edge kernel of one call, its column tiles staged when they fit; w0d
// (w0's last row) in the compute dtype.
template <typename WT>
static cudaError_t edge_fwd(const float* part, int proj_splits,
                            const float* b0, float* Pi, float* Pj,
                            const float* pos, const int32_t* src,
                            const int32_t* dst, const WT* w0d, float* S,
                            float* deg, int B, int A, int E, int H,
                            int block_e, int block_h, cudaStream_t s) {
  const int be = min(block_e, max(E, 1));
  const bool staged = edge_fwd_smem(A, be, block_h, true) <= kEdgeSmemBudget;
  const size_t esmem = edge_fwd_smem(A, be, block_h, staged);
  if (esmem > kEdgeSmemBudget) return cudaErrorInvalidValue;
  cudaError_t err =
      allow_smem_once(staged ? (const void*)egnn_edge_fwd_kernel<true, WT>
                             : (const void*)egnn_edge_fwd_kernel<false, WT>,
                      232448);
  if (err != cudaSuccess) return err;
  dim3 grid((H + block_h - 1) / block_h, B);
  if (staged)
    egnn_edge_fwd_kernel<true, WT><<<grid, EF_THREADS, esmem, s>>>(
        part, proj_splits, b0, Pi, Pj, pos, src, dst, w0d, S, deg, A, E, H,
        block_h, be);
  else
    egnn_edge_fwd_kernel<false, WT><<<grid, EF_THREADS, esmem, s>>>(
        part, proj_splits, b0, Pi, Pj, pos, src, dst, w0d, S, deg, A, E, H,
        block_h, be);
  return cudaGetLastError();
}

// h (B,A,H), pos (B,A,3) f32; src/dst (B,E) int32, dst >= A for edges that
// contribute nothing; w0 the whole fc0 weight (2H+1, H) = [w0i; w0j; w0d];
// b0, b1 (H,); w1 (H,H); out (B,A,H). Scratch from the caller: Pi, Pj, S
// (B,A,H) and deg (B,A), which the wrapper keeps for the backward; `part`
// (2, proj_splits, B·A, H) when proj_splits > 1 and `out_part` (fc1_splits,
// B·A, H) when fc1_splits > 1, else null. All f32, contiguous. block_h a
// multiple of 32 up to 256.
extern "C" int egnn_edge_fwd_launch(const float* h, const float* pos,
                                    const int32_t* src, const int32_t* dst,
                                    const float* w0, const float* b0,
                                    const float* w1, const float* b1,
                                    float* out, float* Pi, float* Pj,
                                    float* S, float* deg, float* part,
                                    float* out_part, int B, int A, int E,
                                    int H, int block_e, int block_h,
                                    int proj_splits, int fc1_splits,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (block_h < 32 || block_h > EF_THREADS || block_h % 32 || block_e < 1 ||
      A < 1 || proj_splits < 1 || fc1_splits < 1 ||
      (proj_splits > 1 && part == nullptr) ||
      (fc1_splits > 1 && out_part == nullptr))
    return (int)cudaErrorInvalidValue;
  const int M = B * A;
  const size_t MH = (size_t)M * H;
  const float* w0i = w0;
  const float* w0j = w0 + (size_t)H * H;
  const float* w0d = w0 + (size_t)2 * H * H;

  // 1. Pi (+ b0) and Pj, or their partials
  TcLaunch l1{};
  l1.count = 2;
  if (proj_splits > 1) {
    l1.p[0] = tc_prob(false, false, h, w0i, part, M, H, H);
    l1.p[1] = tc_prob(false, false, h, w0j, part + proj_splits * MH, M, H, H);
    l1.p[0].splits = l1.p[1].splits = proj_splits;
  } else {
    l1.p[0] = tc_prob(false, false, h, w0i, Pi, M, H, H);
    l1.p[0].bias = b0;
    l1.p[1] = tc_prob(false, false, h, w0j, Pj, M, H, H);
  }
  cudaError_t err = gemm_tc<tc::NN>(l1, s);
  if (err != cudaSuccess) return (int)err;

  // 2. the edge kernel
  err = edge_fwd(part, proj_splits, b0, Pi, Pj, pos, src, dst, w0d, S, deg,
                 B, A, E, H, block_e, block_h, s);
  if (err != cudaSuccess) return (int)err;

  // 3. agg = S·w1 + deg ⊗ b1, or its partials
  TcLaunch l2{};
  l2.count = 1;
  TcProb& fc1 = l2.p[0];
  fc1 = tc_prob(false, false, S, w1, fc1_splits > 1 ? out_part : out, M, H,
                H);
  if (fc1_splits > 1) {
    fc1.splits = fc1_splits;
  } else {
    fc1.bias = b1;
    fc1.row_scale = deg;
  }
  err = gemm_tc<tc::NN>(l2, s);
  if (err != cudaSuccess || fc1_splits == 1) return (int)err;

  // 4. agg's partials summed in split order, + deg ⊗ b1
  TcLaunch l3{};
  l3.red = tc_reduce(out_part, out, nullptr, M, H, fc1_splits,
                     FWD_REDUCE_ELEMS);
  l3.red.bias = b1;
  l3.red.row_scale = deg;
  return (int)gemm_tc<tc::NN>(l3, s);
}

// The bf16 forward (compute dtype bf16): h (B,A,H), w0 (2H+1, H), b0, b1
// (H,) and w1 (H,H) bf16; out (B,A,H) bf16. Pi, Pj, S (B,A,H) and deg
// (B,A) stay f32 scratch, which the backward reads. Three launches, none
// split:
// gemm_bf16 (Pi = h·w0i + b0, Pj = h·w0j), the edge kernel (unchanged, on
// f32 Pi and Pj), gemm_bf16 (out = bf16(S·w1 + deg ⊗ b1), S rounded to
// bf16 as it is staged).
extern "C" int egnn_edge_fwd_bf16_launch(
    const void* h, const float* pos, const int32_t* src, const int32_t* dst,
    const void* w0, const void* b0, const void* w1, const void* b1,
    void* out, float* Pi, float* Pj, float* S, float* deg,
    int B, int A, int E, int H, int block_e, int block_h, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (block_h < 32 || block_h > EF_THREADS || block_h % 32 || block_e < 1 ||
      A < 1)
    return (int)cudaErrorInvalidValue;
  const int M = B * A;
  const __nv_bfloat16* w0i = static_cast<const __nv_bfloat16*>(w0);
  const __nv_bfloat16* w0j = w0i + (size_t)H * H;
  const __nv_bfloat16* w0d = w0i + (size_t)2 * H * H;

  // 1. Pi (+ b0) and Pj
  BfLaunch l1{};
  l1.count = 2;
  l1.p[0] = bf_prob(h, false, w0i, Pi, false, M, H, H);
  l1.p[0].bias = static_cast<const __nv_bfloat16*>(b0);
  l1.p[1] = bf_prob(h, false, w0j, Pj, false, M, H, H);
  cudaError_t err = gemm_bf16(l1, s);
  if (err != cudaSuccess) return (int)err;

  // 2. the edge kernel
  err = edge_fwd(nullptr, 1, nullptr, Pi, Pj, pos, src, dst, w0d, S, deg, B,
                 A, E, H, block_e, block_h, s);
  if (err != cudaSuccess) return (int)err;

  // 3. out = S·w1 + deg ⊗ b1, rounded to bf16
  BfLaunch l2{};
  l2.count = 1;
  l2.p[0] = bf_prob(S, true, static_cast<const __nv_bfloat16*>(w1), out,
                    true, M, H, H);
  l2.p[0].bias = static_cast<const __nv_bfloat16*>(b1);
  l2.p[0].row_scale = deg;
  return (int)gemm_bf16(l2, s);
}
