// Fused EGNN edge message + aggregation, backward, fp32, deterministic.
//
// Replaces the Pallas TPU kernel `egnn_edge_fused_bwd` (_edge_bwd_kernel) of
// src/repro/kernels/egnn_edge/kernel.py. Given g = d loss / d agg (B,A,H)
// for the forward of csrc/egnn_edge.cu it returns dh (B,A,H), dpos (B,A,3)
// and the φ_e cotangents dw0 = [dw0i; dw0j; dw0d] (2H+1,H), db0, dw1 (H,H)
// and db1, all f32. Edges with dst >= A (masked or pad) contribute exactly
// nothing; gathers clamp src to A-1, as the forward does.
//
// The TPU kernel recomputes the per-edge form (z for every edge and column
// from gathered h rows: ~8·2·B·E·H² operations). The forward's
// node-projection algebra holds backwards too. With Pi = h·w0i + b0,
// Pj = h·w0j, z_e = Pi[src_e] + Pj[dst_e] + d²_e·w0d, s_e = silu(z_e),
// S = per-destination sum of s_e and deg = edges per destination (Pi, Pj,
// S, deg saved by the forward; node-major, B·A·H f32 each):
//
//   1. dS = g·w1ᵀ                                (GEMM, K = H)
//      dw1 = Sᵀ·g,  db1 = degᵀ·g                 (GEMM, K = B·A nodes)
//   2. edge kernel, per valid edge e and column c:
//        dz = dS[dst_e]·silu'(z_e);  dPi[src_e] += dz;  dPj[dst_e] += dz;
//        dw0d += dz·d²_e;  dd²_e = sum_c dz·w0d (per-warp partials)
//   3. dpos kernel: dd²_e = sum of its partials in order; dpos[src] +=
//        2·diff·dd², dpos[dst] -= 2·diff·dd² (skipped when pos needs no
//        gradient)
//   4. dh = dPi·w0iᵀ + dPj·w0jᵀ                 (GEMM, two terms, K = H)
//      dw0i = hᵀ·dPi, dw0j = hᵀ·dPj, db0 = 1ᵀ·dPi   (GEMM, K = B·A)
//      dw0d = 1ᵀ·(per-graph partials)          (GEMM, K = B)
//
// Bound: at (B=8, A=64, E=2048, H=866) the six node-level products do
// 6·2·B·A·H² ≈ 4.6 GFLOP and the edge kernel ~15 operations per valid edge
// and column (~0.2 GFLOP at ~13.7k valid edges): ~71 us at the 67 TFLOP/s
// fp32 non-tensor peak — operations bound it. Plain fp32 FFMA, no TF32.
//
// No float atomics anywhere, so two calls on the same inputs give the same
// bits. Every output element has one owner thread and a fixed order:
// the edge kernel gives each (graph, column) one thread per edge group that
// walks its share of the edges in order into two (A x block_h) shared
// partials (dPi, dPj), summed in group order; dd²_e spans every column, so
// each warp (32 columns) writes its own partial for the edge and the dpos
// kernel sums the partials in warp order, its (node, coordinate) owner
// threads walking the edges in order. Weight gradients reduce over nodes
// inside the GEMMs, k in order.
#include "common.cuh"
#include "gemm_f32.cuh"

constexpr unsigned FULL = 0xffffffffu;
constexpr int EU = 4;   // edges in flight per thread

// ---------------------------------------------------------------------------
// Edge kernel: one CTA per (column tile of block_h, graph); blockDim =
// (block_h, groups), block_h a multiple of 32, so a warp lies in one group
// and walks the same edges. Per window of block_e edges the CTA stages
// src (clamped), dst (>= A -> -1) and d² in shared memory.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(512)
egnn_edge_bwd_kernel(const float* __restrict__ Pi,
                     const float* __restrict__ Pj,
                     const float* __restrict__ dS,
                     const float* __restrict__ pos,
                     const int32_t* __restrict__ src,
                     const int32_t* __restrict__ dst,
                     const float* __restrict__ w0d, float* __restrict__ dPi,
                     float* __restrict__ dPj, float* __restrict__ dw0d_part,
                     float* __restrict__ dd2_part, int A, int E, int H,
                     int block_e) {
  extern __shared__ float smem[];
  const int block_h = blockDim.x, groups = blockDim.y;
  float* acc_i = smem;                                   // [G][A][block_h]
  float* acc_j = acc_i + (size_t)groups * A * block_h;   // [G][A][block_h]
  float* wpart = acc_j + (size_t)groups * A * block_h;   // [G][block_h]
  float* d2_s = wpart + groups * block_h;                // [block_e]
  int* src_s = reinterpret_cast<int*>(d2_s + block_e);   // [block_e]
  int* dst_s = src_s + block_e;                          // [block_e]

  const int tid = threadIdx.x, g = threadIdx.y;
  const int flat = g * block_h + tid, nthreads = groups * block_h;
  const int c = blockIdx.x * block_h + tid;
  const int b = blockIdx.y;
  const bool active = c < H;
  const int W = (H + 31) / 32;                 // warp column tiles
  const bool lane0 = (tid & 31) == 0;
  float* my_i = acc_i + (size_t)g * A * block_h;
  float* my_j = acc_j + (size_t)g * A * block_h;
  for (int a = 0; a < A; ++a) {
    my_i[a * block_h + tid] = 0.f;
    my_j[a * block_h + tid] = 0.f;
  }

  const float wd = active ? w0d[c] : 0.f;
  const size_t node0 = (size_t)b * A * H + (active ? c : 0);
  const float* pi = Pi + node0;
  const float* pj = Pj + node0;
  const float* ds = dS + node0;
  const float* pb = pos + (size_t)b * A * 3;
  const int32_t* sr = src + (size_t)b * E;
  const int32_t* dr = dst + (size_t)b * E;
  // a warp with no column below H has no partial (and skips the shuffles)
  const bool warp_active = (c & ~31) < H;
  float* dd2 = dd2_part && warp_active
                   ? dd2_part + ((size_t)b * W + c / 32) * E : nullptr;
  float gw = 0.f;                               // this thread's dw0d share

  for (int e0 = 0; e0 < E; e0 += block_e) {
    const int ne = min(block_e, E - e0);
    __syncthreads();                       // previous window consumed
    for (int i = flat; i < ne; i += nthreads) {
      const int d = dr[e0 + i];
      const int s = min(sr[e0 + i], A - 1);          // clamped gather
      const int dc = min(d, A - 1);
      const float ex = pb[s * 3 + 0] - pb[dc * 3 + 0];
      const float ey = pb[s * 3 + 1] - pb[dc * 3 + 1];
      const float ez = pb[s * 3 + 2] - pb[dc * 3 + 2];
      d2_s[i] = ex * ex + ey * ey + ez * ez;
      src_s[i] = s;
      dst_s[i] = (d >= 0 && d < A) ? d : -1;
    }
    __syncthreads();
    const int share = (ne + groups - 1) / groups;
    const int lo = min(ne, g * share), hi = min(ne, lo + share);
    for (int i = lo; i < hi; i += EU) {
      int d[EU], s[EU];
      float v[EU];
#pragma unroll
      for (int u = 0; u < EU; ++u) {     // loads of EU edges in flight
        d[u] = i + u < hi ? dst_s[i + u] : -1;
        s[u] = d[u] >= 0 ? src_s[i + u] : 0;
        v[u] = 0.f;
        if (d[u] >= 0 && active) {
          const float z = pi[(size_t)s[u] * H] + pj[(size_t)d[u] * H] +
                          d2_s[i + u] * wd;
          const float sig = 1.f / (1.f + expf(-z));
          v[u] = ds[(size_t)d[u] * H] * (sig * (1.f + z * (1.f - sig)));
        }
      }
#pragma unroll
      for (int u = 0; u < EU; ++u) {     // then the sums, in edge order
        if (d[u] < 0) continue;          // the same for the whole warp
        if (active) {
          my_i[s[u] * block_h + tid] += v[u];
          my_j[d[u] * block_h + tid] += v[u];
          gw = fmaf(v[u], d2_s[i + u], gw);
        }
        if (dd2) {
          float p = v[u] * wd;
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) p += __shfl_xor_sync(FULL, p, o);
          if (lane0) dd2[e0 + i + u] = p;
        }
      }
    }
  }
  wpart[g * block_h + tid] = gw;
  __syncthreads();
  for (int a = g; a < A; a += groups) {
    if (!active) continue;
    float vi = 0.f, vj = 0.f;
    for (int q = 0; q < groups; ++q) {
      vi += acc_i[((size_t)q * A + a) * block_h + tid];
      vj += acc_j[((size_t)q * A + a) * block_h + tid];
    }
    dPi[((size_t)b * A + a) * H + c] = vi;
    dPj[((size_t)b * A + a) * H + c] = vj;
  }
  if (g == 0 && active) {
    float v = 0.f;
    for (int q = 0; q < groups; ++q) v += wpart[q * block_h + tid];
    dw0d_part[(size_t)b * H + c] = v;
  }
}

// ---------------------------------------------------------------------------
// dpos kernel: one CTA per graph. Per window of block_e edges the threads
// sum each valid edge's W per-warp partials of dd² in order and stage
// 2·diff·dd² with its (clamped src, dst); then each (node, coordinate)
// owner thread walks the window in edge order, adding the edges that leave
// its node and subtracting those that arrive.
// ---------------------------------------------------------------------------
constexpr int DPOS_THREADS = 256;

__global__ void __launch_bounds__(DPOS_THREADS)
egnn_edge_dpos_kernel(const float* __restrict__ dd2_part,
                      const float* __restrict__ pos,
                      const int32_t* __restrict__ src,
                      const int32_t* __restrict__ dst,
                      float* __restrict__ dpos, int A, int E, int W,
                      int block_e) {
  extern __shared__ float smem[];
  float* acc = smem;                                     // [A*3]
  float* con = acc + 3 * A;                              // [block_e][3]
  int* src_s = reinterpret_cast<int*>(con + 3 * block_e);
  int* dst_s = src_s + block_e;
  const int b = blockIdx.x, tid = threadIdx.x;
  const float* pb = pos + (size_t)b * A * 3;
  const int32_t* sr = src + (size_t)b * E;
  const int32_t* dr = dst + (size_t)b * E;
  const float* part = dd2_part + (size_t)b * W * E;
  for (int p = tid; p < 3 * A; p += blockDim.x) acc[p] = 0.f;

  for (int e0 = 0; e0 < E; e0 += block_e) {
    const int ne = min(block_e, E - e0);
    __syncthreads();
    for (int i = tid; i < ne; i += blockDim.x) {
      const int e = e0 + i;
      const int d = dr[e];
      if (d < 0 || d >= A) {
        src_s[i] = dst_s[i] = -1;
        continue;
      }
      const int s = min(sr[e], A - 1);
      float dd2 = 0.f;
      for (int w = 0; w < W; ++w) dd2 += part[(size_t)w * E + e];
#pragma unroll
      for (int k = 0; k < 3; ++k)
        con[i * 3 + k] = 2.f * (pb[s * 3 + k] - pb[d * 3 + k]) * dd2;
      src_s[i] = s;
      dst_s[i] = d;
    }
    __syncthreads();
    for (int p = tid; p < 3 * A; p += blockDim.x) {
      const int a = p / 3, k = p % 3;
      float v = acc[p];
      for (int i = 0; i < ne; ++i) {
        if (src_s[i] == a) v += con[i * 3 + k];
        if (dst_s[i] == a) v -= con[i * 3 + k];
      }
      acc[p] = v;
    }
  }
  __syncthreads();
  for (int p = tid; p < 3 * A; p += blockDim.x)
    dpos[(size_t)b * A * 3 + p] = acc[p];
}

// g, h, Pi, Pj, S (B,A,H); deg (B,A); pos (B,A,3) f32; src/dst (B,E) int32
// with dst >= A for edges that contribute nothing; w0 the whole fc0 weight
// (2H+1, H) = [w0i; w0j; w0d]; w1 (H,H). Outputs: dh (B,A,H); dw0 (2H+1,H);
// db0, db1 (H,); dw1 (H,H); dpos (B,A,3) or null (then dd2_part is not
// used either). Scratch from the caller: dS, dPi, dPj (B,A,H), dw0d_part
// (B,H) and dd2_part (B, ceil(H/32), E) or null. All f32, contiguous.
// block_h x groups <= 512.
extern "C" int egnn_edge_bwd_launch(
    const float* g, const float* h, const float* pos, const int32_t* src,
    const int32_t* dst, const float* w0, const float* w1, const float* Pi,
    const float* Pj, const float* S, const float* deg, float* dh,
    float* dpos, float* dw0, float* db0, float* dw1, float* db1, float* dS,
    float* dPi, float* dPj, float* dw0d_part, float* dd2_part, int B, int A,
    int E, int H, int block_e, int block_h, int groups, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * A;
  const float* w0i = w0;
  const float* w0j = w0 + (size_t)H * H;
  const float* w0d = w0 + (size_t)2 * H * H;
  if (dpos == nullptr) dd2_part = nullptr;

  // 1. dS = g·w1ᵀ; dw1 = Sᵀ·g and db1 = degᵀ·g
  GemmBatch ds_batch{};
  ds_batch.p[0] = gemm_prob(g, w1, dS, M);
  cudaError_t err = gemm<false, true>(ds_batch, 1, M, H, H, s);
  if (err != cudaSuccess) return (int)err;
  GemmBatch w1_batch{};
  w1_batch.p[0] = gemm_prob(S, g, dw1, H);
  w1_batch.p[1] = gemm_prob(deg, g, db1, 1);
  err = gemm<true, false>(w1_batch, 2, H, H, M, s);
  if (err != cudaSuccess) return (int)err;

  // 2. the edge kernel
  const size_t smem =
      ((size_t)groups * (2 * A * block_h + block_h) + block_e) *
          sizeof(float) +
      (size_t)2 * block_e * sizeof(int);
  err = allow_smem(egnn_edge_bwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((H + block_h - 1) / block_h, B);
  dim3 block(block_h, groups);
  egnn_edge_bwd_kernel<<<grid, block, smem, s>>>(
      Pi, Pj, dS, pos, src, dst, w0d, dPi, dPj, dw0d_part, dd2_part, A, E, H,
      block_e);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // 3. dpos
  if (dpos != nullptr) {
    const size_t psmem =
        (size_t)3 * A * sizeof(float) +
        (size_t)block_e * (3 * sizeof(float) + 2 * sizeof(int));
    err = allow_smem(egnn_edge_dpos_kernel, psmem);
    if (err != cudaSuccess) return (int)err;
    egnn_edge_dpos_kernel<<<B, DPOS_THREADS, psmem, s>>>(
        dd2_part, pos, src, dst, dpos, A, E, (H + 31) / 32, block_e);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }

  // 4. dh = dPi·w0iᵀ + dPj·w0jᵀ; dw0i = hᵀ·dPi, dw0j = hᵀ·dPj,
  //    db0 = 1ᵀ·dPi; dw0d = 1ᵀ·dw0d_part
  GemmBatch dh_batch{};
  dh_batch.p[0] = gemm_prob(dPi, w0i, dh, M);
  dh_batch.p[0].A[1] = dPj;
  dh_batch.p[0].B[1] = w0j;
  dh_batch.p[0].terms = 2;
  err = gemm<false, true>(dh_batch, 1, M, H, H, s);
  if (err != cudaSuccess) return (int)err;
  GemmBatch w0_batch{};
  w0_batch.p[0] = gemm_prob(h, dPi, dw0, H);
  w0_batch.p[1] = gemm_prob(h, dPj, dw0 + (size_t)H * H, H);
  w0_batch.p[2] = gemm_prob(nullptr, dPi, db0, 1);
  err = gemm<true, false>(w0_batch, 3, H, H, M, s);
  if (err != cudaSuccess) return (int)err;
  GemmBatch wd_batch{};
  wd_batch.p[0] = gemm_prob(nullptr, dw0d_part, dw0 + (size_t)2 * H * H, 1);
  return (int)gemm<true, false>(wd_batch, 1, 1, H, B, s);
}
