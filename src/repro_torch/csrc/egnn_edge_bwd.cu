// Fused EGNN edge message + aggregation, backward, fp32, deterministic.
//
// Replaces the Pallas TPU kernel `egnn_edge_fused_bwd` (_edge_bwd_kernel,
// src/repro/kernels/egnn_edge/kernel.py:319). Given g = d loss / d agg
// (B,A,H) for the forward of csrc/egnn_edge.cu it returns dh (B,A,H), dpos
// (B,A,3) and the φ_e cotangents dw0 = [dw0i; dw0j; dw0d] (2H+1,H), db0,
// dw1 (H,H) and db1, all f32. Edges with dst >= A (masked or pad)
// contribute exactly nothing; gathers clamp src to A-1, as the forward
// does. Under bf16 compute g, h and the weights arrive in bf16 (`in_bf16`)
// and are read as they are, converted to f32 where gemm_tc.cuh stages them;
// the math stays in f32 (repro's chain rule, kernel.py:245-287, and the
// gradient of csrc/egnn_edge.cu's bf16 forward, whose z is f32), so the
// outputs are the bits of this backward on their f32 copies.
//
// The TPU kernel recomputes the per-edge form (z for every edge and column
// from gathered h rows: ~8·2·B·E·H² operations). The forward's
// node-projection algebra holds backwards too. With Pi = h·w0i + b0,
// Pj = h·w0j, z_e = Pi[src_e] + Pj[dst_e] + d²_e·w0d, s_e = silu(z_e),
// S = per-destination sum of s_e and deg = edges per destination (Pi, Pj,
// S, deg saved by the forward; node-major, B·A·H f32 each), a call is
// three launches (four with dpos):
//
//   1. gemm_tc: dw1 = Sᵀ·g with db1 = degᵀ·g as its extra row (K = B·A
//      nodes, cut into `w1_splits` k-ranges), and dS = g·w1ᵀ (K = H);
//   2. edge kernel, per valid edge e and column c:
//        dz = dS[dst_e]·silu'(z_e);  dPi[src_e] += dz;  dPj[dst_e] += dz;
//        dw0d += dz·d²_e;  dd²_e = sum_c dz·w0d (per-warp partials, only
//        when pos needs a gradient);
//   3. dpos kernel (only when pos needs a gradient): dd²_e = sum of its
//      partials in order; dpos[src] += 2·diff·dd², dpos[dst] -= 2·diff·dd²;
//   4. gemm_tc: dw1's split sums (reduce items), dw0i = hᵀ·dPi with
//      db0 = 1ᵀ·dPi as its extra row, dw0j = hᵀ·dPj (K = B·A),
//      dh = dPi·w0iᵀ + dPj·w0jᵀ (two terms, K = H), dw0d = 1ᵀ·(per-graph
//      partials) (K = B).
//
// Bound, at the training path's shape (B=40, A=64, E=2048, H=866, ~68.9k
// valid edges, no dpos): the six node-level products do 6·2·B·A·H² =
// 23.0 GFLOP, the edge kernel ~15 operations per valid edge and column
// (0.9 GFLOP). On the tensor cores as three TF32 products (495 TFLOP/s)
// plus the edge work at the 67 TFLOP/s fp32 peak that is ~0.153 ms; the
// same work in fp32 FFMA would be ~0.357 ms; the ~72 MB the call must move
// take ~0.021 ms at 3.35 TB/s. Operations bound it.
//
// What the design does about it:
//   * The products run on the tensor cores at fp32 accuracy: 3xTF32 on
//     wgmma in gemm_tc.cuh, the accumulator folded into an f32 sum every
//     64 k, grouped so that a call is two GEMM launches. dw1's split-K
//     evens out launch 1 over the SMs (kernels/egnn_edge/gemm_plan.py); the
//     split partials are summed in split order by launch 4, never with
//     atomics.
//   * The edge kernel reads shared memory only in its walks. One CTA per
//     (32-column tile group of `block_h`, graph) stages the graph's Pi, Pj
//     and dS column tiles, then compacts the graph's edges, in edge order,
//     into one list per destination node and one per source node (per-warp
//     __match_any_sync counts of 8 chunks loaded at once, an exclusive
//     scan over nodes and warps, a second walk that places each edge with
//     its d²). The warp that owns node a walks a's destination list:
//     Pi[src] from shared memory, Pj[a] and dS[a] in registers, dz, dPj[a]
//     summed in a register; then a's source list, computing the same dz
//     again from Pj[dst] and dS[dst], dPi[a] in a register. Four listed
//     edges are computed at once without branches; every sum is written
//     once. Recomputing dz for the source walk costs two more SFU
//     operations an edge and column but keeps no dz window, so a CTA needs
//     ~64 KB and three fit on an SM.
//
// Determinism: no float atomics anywhere, so two calls on the same inputs
// give the same bits. dPi[a] and dPj[a] are summed in edge order alone
// (block_e and block_h change no bit of them). dw0d's per-graph partial
// sums each lane's edges (owned nodes, edges in order), then the node-group
// warps in order; dd²_e's per-warp partials are summed in warp order by the
// dpos kernel, its (node, coordinate) owner threads walking the edges in
// order. The products sum k-steps in order, then splits in order. Every
// order depends on the shapes and the plan alone.
//
// sigmoid is 1 / (1 + 2^(-z·log2 e)) through the SFU (__expf, __fdividef):
// a few ulp from expf, far inside the backward's 1e-4 tolerance.
#include "common.cuh"
#include "edge_lists.cuh"
#include "gemm_tc.cuh"

constexpr int EB_WARPS = 8;            // warps of the edge kernel
constexpr int EB_THREADS = 32 * EB_WARPS;
constexpr int EU = 4;                  // listed edges in flight a warp
constexpr size_t kEdgeSmemBudget = 231424;   // budget.SMEM_BUDGET

// Dynamic shared memory of the edge kernel (bytes): the staged column
// tiles of Pi, Pj and dS when `staged`, the two edge lists, per-warp counts,
// list offsets, node positions and the warps' dw0d shares. Kept equal to
// budget.smem_bytes(..., bwd=True).
static inline size_t edge_bwd_smem(int A, int E, int bh, bool staged) {
  return (staged ? (size_t)12 * A * bh : 0) + (size_t)16 * E +
         (size_t)84 * A + 8 + 4 * EB_THREADS;
}

// The gradient of one edge and column: dS[dst]·silu'(z), z = Pi[src] +
// Pj[dst] + d²·w0d.
__device__ __forceinline__ float edge_dz(float pi, float pj, float ds,
                                         float d2, float wd) {
  const float z = pi + pj + d2 * wd;
  const float sig = __fdividef(1.f, 1.f + __expf(-z));
  return ds * (sig * (1.f + z * (1.f - sig)));
}

// ---------------------------------------------------------------------------
// Edge kernel: one CTA per (column tile of block_h, graph). Its 8 warps are
// block_h/32 column groups (32 columns a warp, a lane a column) times
// 8/(block_h/32) node groups: node group q owns the nodes q, q + groups, ...
// The CTA compacts the graph's edges into one list per destination and one
// per source node, in edge order; then each owner walks its destinations'
// lists (dz, dPj, dw0d, dd²) and its sources' lists (dz again, dPi).
// STAGED: Pi, Pj and dS column tiles in shared memory, else read from
// global memory (graphs whose tiles do not fit).
// ---------------------------------------------------------------------------
template <bool STAGED, typename WT>
__global__ void __launch_bounds__(EB_THREADS, 3)
egnn_edge_bwd_kernel(const float* __restrict__ Pi,
                     const float* __restrict__ Pj,
                     const float* __restrict__ dS,
                     const float* __restrict__ pos,
                     const int32_t* __restrict__ src,
                     const int32_t* __restrict__ dst,
                     const WT* __restrict__ w0d, float* __restrict__ dPi,
                     float* __restrict__ dPj, float* __restrict__ dw0d_part,
                     float* __restrict__ dd2_part, int A, int E, int H,
                     int bh) {
  extern __shared__ __align__(16) unsigned char eb_smem[];
  int2* list_d = reinterpret_cast<int2*>(eb_smem);   // [E] (s, d²) by dst
  int2* list_s = list_d + E;                          // [E] (d, d²) by src
  float* tiles = reinterpret_cast<float*>(list_s + E);  // [3][A][bh]
  int* cnt_d = reinterpret_cast<int*>(tiles + (STAGED ? 3 * A * bh : 0));
  int* cnt_s = cnt_d + EB_WARPS * A;                  // [warps][A]
  int* off_d = cnt_s + EB_WARPS * A;                  // [A + 1]
  int* off_s = off_d + A + 1;                         // [A + 1]
  float* pos_s = reinterpret_cast<float*>(off_s + A + 1);  // [A][3]
  float* wpart = pos_s + 3 * A;                       // [warps][32]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y;
  const int ncg = bh / 32, nng = EB_WARPS / ncg;
  const int cg = warp % ncg, ng = warp / ncg;
  const bool owner = ng < nng;          // a warp past ncg x nng only helps
  const int c0 = blockIdx.x * bh;       // the tile's first column
  const int cc = cg * 32 + lane;        // this lane's column in the tile
  const int c = c0 + cc;
  const bool active = owner && c < H;
  // a warp with no column below H has no dd² partial (and no shuffles)
  const bool warp_cols = owner && c0 + cg * 32 < H;
  float* dd2 = dd2_part != nullptr && warp_cols
                   ? dd2_part + ((size_t)b * ((H + 31) / 32) +
                                 (c0 + cg * 32) / 32) * E
                   : nullptr;
  const float wd = active ? to_f32(w0d[c]) : 0.f;
  const size_t node0 = (size_t)b * A * H;
  const int32_t* sr = src + (size_t)b * E;
  const int32_t* dr = dst + (size_t)b * E;

  // node a's value in this lane's column: row a of a tile (zero past H)
  const float* pi_t = STAGED ? tiles : Pi + node0 + c0;
  const float* pj_t = STAGED ? tiles + A * bh : Pj + node0 + c0;
  const float* ds_t = STAGED ? tiles + 2 * A * bh : dS + node0 + c0;
  const int ldt = STAGED ? bh : H;
  const int col = active ? cc : 0;      // inactive lanes read a valid cell
  if (STAGED) {
    const float* g3[3] = {Pi, Pj, dS};
#pragma unroll
    for (int m = 0; m < 3; ++m)
      for (int idx = tid; idx < A * bh; idx += EB_THREADS) {
        const int a = idx / bh, q = idx - a * bh;
        tiles[m * A * bh + idx] =
            c0 + q < H ? g3[m][node0 + (size_t)a * H + c0 + q] : 0.f;
      }
  }
  for (int i = tid; i < 3 * A; i += EB_THREADS)
    pos_s[i] = pos[(size_t)b * A * 3 + i];
  for (int a = lane; a < A; a += 32) {
    cnt_d[warp * A + a] = 0;
    cnt_s[warp * A + a] = 0;
  }
  __syncthreads();

  // each warp counts its contiguous share of the graph's 32-edge chunks per
  // node (src clamped; an edge with dst out of range is in no list)
  const int nch = (E + 31) / 32, cpw = (nch + EB_WARPS - 1) / EB_WARPS;
  const int ch0 = min(nch, warp * cpw), ch1 = min(nch, ch0 + cpw);
  const unsigned lt = (1u << lane) - 1;
  for (int ch = ch0; ch < ch1; ch += 8) {
    int kd[8], ks[8];
    chunk_keys(dr, sr, A, E, ch, ch1, kd, ks);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const unsigned md = __match_any_sync(FULL, kd[j]);
      const unsigned ms = __match_any_sync(FULL, ks[j]);
      if (kd[j] >= 0 && (md & lt) == 0) cnt_d[warp * A + kd[j]] += __popc(md);
      if (ks[j] >= 0 && (ms & lt) == 0) cnt_s[warp * A + ks[j]] += __popc(ms);
      __syncwarp();
    }
  }
  __syncthreads();

  // list offsets: warp 0 the destination lists, warp 1 the source lists
  if (warp < 2)
    list_offsets<EB_WARPS>(warp ? cnt_s : cnt_d, warp ? off_s : off_d, A);
  __syncthreads();

  // the same walk again places each edge: lists in edge order
  for (int ch = ch0; ch < ch1; ch += 8) {
    int kd[8], ks[8];
    chunk_keys(dr, sr, A, E, ch, ch1, kd, ks);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const unsigned md = __match_any_sync(FULL, kd[j]);
      const unsigned ms = __match_any_sync(FULL, ks[j]);
      if (kd[j] >= 0) {
        const float ex = pos_s[ks[j] * 3 + 0] - pos_s[kd[j] * 3 + 0];
        const float ey = pos_s[ks[j] * 3 + 1] - pos_s[kd[j] * 3 + 1];
        const float ez = pos_s[ks[j] * 3 + 2] - pos_s[kd[j] * 3 + 2];
        const int d2 = __float_as_int(ex * ex + ey * ey + ez * ez);
        const int e = (ch + j) * 32 + lane;
        list_d[cnt_d[warp * A + kd[j]] + __popc(md & lt)] =
            make_int2(ks[j] | (e << 16), d2);
        list_s[cnt_s[warp * A + ks[j]] + __popc(ms & lt)] =
            make_int2(kd[j] | (e << 16), d2);
      }
      __syncwarp();
      if (kd[j] >= 0 && (md & lt) == 0) cnt_d[warp * A + kd[j]] += __popc(md);
      if (ks[j] >= 0 && (ms & lt) == 0) cnt_s[warp * A + ks[j]] += __popc(ms);
      __syncwarp();
    }
  }
  __syncthreads();

  float gw = 0.f;                       // this lane's dw0d share
  for (int a = ng; owner && a < A; a += nng) {
    // node a's destination list: dz, dPj, dw0d, dd²
    const float pj = active ? pj_t[a * ldt + col] : 0.f;
    const float ds = active ? ds_t[a * ldt + col] : 0.f;
    float acc = 0.f;
    const int lo = off_d[a], hi = off_d[a + 1];
    for (int q = lo; q < hi; q += EU) {
      float dz[EU], d2[EU];
      int e[EU];
#pragma unroll
      for (int u = 0; u < EU; ++u) {   // EU listed edges in flight
        const int2 ent = list_d[min(q + u, hi - 1)];
        const int s = ent.x & 0xffff;
        e[u] = (unsigned)ent.x >> 16;
        d2[u] = __int_as_float(ent.y);
        dz[u] = edge_dz(pi_t[s * ldt + col], pj, ds, d2[u], wd);
      }
#pragma unroll
      for (int u = 0; u < EU; ++u) {   // then the sums, in list order
        if (q + u >= hi) break;        // the same for the whole warp
        acc += dz[u];
        gw = fmaf(dz[u], d2[u], gw);
        if (dd2) {
          float p = dz[u] * wd;
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) p += __shfl_xor_sync(FULL, p, o);
          if (lane == 0) dd2[e[u]] = p;
        }
      }
    }
    if (active) dPj[node0 + (size_t)a * H + c] = acc;

    // node a's source list: the same dz again, dPi
    const float pi = active ? pi_t[a * ldt + col] : 0.f;
    acc = 0.f;
    const int lo2 = off_s[a], hi2 = off_s[a + 1];
    for (int q = lo2; q < hi2; q += EU) {
      float dz[EU];
#pragma unroll
      for (int u = 0; u < EU; ++u) {
        const int2 ent = list_s[min(q + u, hi2 - 1)];
        const int d = ent.x & 0xffff;
        dz[u] = edge_dz(pi, pj_t[d * ldt + col], ds_t[d * ldt + col],
                        __int_as_float(ent.y), wd);
      }
#pragma unroll
      for (int u = 0; u < EU; ++u) {
        if (q + u >= hi2) break;
        acc += dz[u];
      }
    }
    if (active) dPi[node0 + (size_t)a * H + c] = acc;
  }

  wpart[warp * 32 + lane] = gw;
  __syncthreads();
  if (warp < ncg && c0 + warp * 32 + lane < H) {
    float v = 0.f;
    for (int q = 0; q < nng; ++q) v += wpart[(q * ncg + warp) * 32 + lane];
    dw0d_part[(size_t)b * H + c0 + warp * 32 + lane] = v;
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

// The edge kernel of one call; w0d (w0's last row) in the compute dtype.
template <typename WT>
static cudaError_t edge_bwd(bool staged, size_t esmem, dim3 grid,
                            const float* Pi, const float* Pj,
                            const float* dS, const float* pos,
                            const int32_t* src, const int32_t* dst,
                            const WT* w0d, float* dPi, float* dPj,
                            float* dw0d_part, float* dd2_part, int A, int E,
                            int H, int bh, cudaStream_t s) {
  cudaError_t err =
      allow_smem_once(staged ? (const void*)egnn_edge_bwd_kernel<true, WT>
                             : (const void*)egnn_edge_bwd_kernel<false, WT>,
                      232448);
  if (err != cudaSuccess) return err;
  if (staged)
    egnn_edge_bwd_kernel<true, WT><<<grid, EB_THREADS, esmem, s>>>(
        Pi, Pj, dS, pos, src, dst, w0d, dPi, dPj, dw0d_part, dd2_part, A, E,
        H, bh);
  else
    egnn_edge_bwd_kernel<false, WT><<<grid, EB_THREADS, esmem, s>>>(
        Pi, Pj, dS, pos, src, dst, w0d, dPi, dPj, dw0d_part, dd2_part, A, E,
        H, bh);
  return cudaGetLastError();
}

// g, h, Pi, Pj, S (B,A,H); deg (B,A); pos (B,A,3) f32; src/dst (B,E) int32
// with dst >= A for edges that contribute nothing; w0 the whole fc0 weight
// (2H+1, H) = [w0i; w0j; w0d]; w1 (H,H). With `in_bf16` g, h, w0 and w1
// are bf16, else f32. Outputs: dh (B,A,H); dw0 (2H+1,H);
// db0, db1 (H,); dw1 (H,H); dpos (B,A,3) or null (then dd2_part is not
// used either). Scratch from the caller: dS, dPi, dPj (B,A,H), dw0d_part
// (B,H), dd2_part (B, ceil(H/32), E) or null, and, when w1_splits > 1,
// w1_part (w1_splits, H+1, H). All f32, contiguous. block_h a multiple of
// 32 up to 256; A < 32768 and E < 65536 (the packed edge lists).
extern "C" int egnn_edge_bwd_launch(
    const void* g, const void* h, const float* pos, const int32_t* src,
    const int32_t* dst, const void* w0, const void* w1, const float* Pi,
    const float* Pj, const float* S, const float* deg, float* dh,
    float* dpos, float* dw0, float* db0, float* dw1, float* db1, float* dS,
    float* dPi, float* dPj, float* dw0d_part, float* dd2_part,
    float* w1_part, int B, int A, int E, int H, int block_e, int block_h,
    int w1_splits, int in_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (block_h < 32 || block_h > EB_THREADS || block_h % 32 || A >= 32768 ||
      E >= 65536 || block_e < 1 || w1_splits < 1)
    return (int)cudaErrorInvalidValue;
  const int M = B * A;
  const void* w0i = w0;
  const void* w0j =
      static_cast<const char*>(w0) + (size_t)H * H * (in_bf16 ? 2 : 4);
  float* dw0d = dw0 + (size_t)2 * H * H;
  if (dpos == nullptr) dd2_part = nullptr;

  // 1. dw1 (+ db1), the longer k-range first, then dS
  TcLaunch l1{};
  l1.count = 2;
  TcProb& w1p = l1.p[0];
  w1p = tc_prob(true, false, S, g, dw1, H, H, M);
  w1p.b_bf16 = in_bf16;
  w1p.extra = deg;
  w1p.has_extra = 1;
  w1p.C_extra = db1;
  if (w1_splits > 1) {
    w1p.splits = w1_splits;
    w1p.C = w1_part;
  }
  l1.p[1] = tc_prob(false, true, g, w1, dS, M, H, H);
  l1.p[1].a_bf16 = l1.p[1].b_bf16 = in_bf16;
  cudaError_t err = gemm_tc<tc::MIXED>(l1, s);
  if (err != cudaSuccess) return (int)err;

  // 2. the edge kernel, its column tiles staged when they fit
  const bool staged = edge_bwd_smem(A, E, block_h, true) <= kEdgeSmemBudget;
  const size_t esmem = edge_bwd_smem(A, E, block_h, staged);
  dim3 grid((H + block_h - 1) / block_h, B);
  if (in_bf16)
    err = edge_bwd(staged, esmem, grid, Pi, Pj, dS, pos, src, dst,
                   static_cast<const __nv_bfloat16*>(w0) + (size_t)2 * H * H,
                   dPi, dPj, dw0d_part, dd2_part, A, E, H, block_h, s);
  else
    err = edge_bwd(staged, esmem, grid, Pi, Pj, dS, pos, src, dst,
                   static_cast<const float*>(w0) + (size_t)2 * H * H, dPi,
                   dPj, dw0d_part, dd2_part, A, E, H, block_h, s);
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

  // 4. dw1's split sums, then dw0i (+ db0), dw0j, dh and dw0d
  TcLaunch l2{};
  if (w1_splits > 1) {
    l2.red = tc_reduce(w1_part, dw1, db1, H, H, w1_splits, tc::REDUCE_ELEMS);
  }
  l2.count = 4;
  l2.p[0] = tc_prob(true, false, h, dPi, dw0, H, H, M);
  l2.p[0].has_extra = 1;                       // ones: db0 = 1ᵀ·dPi
  l2.p[0].C_extra = db0;
  l2.p[1] = tc_prob(true, false, h, dPj, dw0 + (size_t)H * H, H, H, M);
  l2.p[0].a_bf16 = l2.p[1].a_bf16 = in_bf16;
  TcProb& dhp = l2.p[2];
  dhp = tc_prob(false, true, dPi, w0i, dh, M, H, H);
  dhp.A[1] = dPj;
  dhp.B[1] = w0j;
  dhp.b_bf16 = in_bf16;
  dhp.terms = 2;
  l2.p[3] = tc_prob(true, false, nullptr, dw0d_part, nullptr, 0, H, B);
  l2.p[3].has_extra = 1;                       // ones: dw0d = 1ᵀ·parts
  l2.p[3].C_extra = dw0d;
  return (int)gemm_tc<tc::MIXED>(l2, s);
}

// CTAs of the backward's GEMM kernel that one SM holds at once (the plan
// assumes 1).
extern "C" int gemm_tc_blocks_per_sm(int* out) {
  cudaError_t err = allow_smem(gemm_tc_kernel<tc::MIXED>, tc::SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, gemm_tc_kernel<tc::MIXED>, tc::THREADS, tc::SMEM_BYTES);
}
