// Fused EGNN edge message + aggregation, forward, fp32, deterministic.
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
// Design: both dense layers of φ_e are linear in what they read, so the
// edge-major work reduces to an elementwise map plus a segment-sum:
//
//   1. node projections (GEMM kernel, both in one launch):
//        Pi = h @ w0i + b0,   Pj = h @ w0j          (B·A x H each)
//   2. edge kernel: s_e = silu(Pi[src_e] + Pj[dst_e] + d2_e·w0d), summed
//        per destination node in edge order: S[b,a] = sum_{e->a} s_e, and
//        deg[b,a] = number of such edges;
//   3. node output (GEMM kernel): agg = S @ w1 + deg ⊗ b1.
//
// This is exact algebra (h[src]·w0i == (h·w0i)[src]; sum_e (s_e·w1 + b1)
// == (sum_e s_e)·w1 + deg·b1); only the fp32 summation order differs from
// the reference. fc0 is never recomputed (factor 1, not ceil(H/BN)): its
// work drops from 2·E·2H·H to 2·A·2H·H per graph, and fc1 from 2·E·H·H to
// 2·A·H·H. Nothing edge-major reaches device memory: no (B,E,2H+1) concat,
// no (B,E,H) message; the scratch is node-major (Pi, Pj, S: B·A·H each).
//
// Bound: at (B=8, A=64, E=2048, H=866) the three GEMMs do 2·B·A·3H² ≈ 2.3
// GFLOP (~34 us at the 67 TFLOP/s fp32 non-tensor peak) and the edge kernel
// reads Pi/Pj rows (L2-resident) — so operations bound it. Plain fp32 FFMA
// from shared-memory tiles, no TF32, mma or wgmma yet. No float atomics
// anywhere: every output element has one owner thread and a fixed order.
// The edge kernel's walk is latency-bound (a chain of dependent gathers per
// thread); edge groups inside each CTA (as many as shared memory allows,
// ``budget.plan_groups``) keep more of those gathers in flight.
#include "common.cuh"

// ---------------------------------------------------------------------------
// C[M,N] = A[M,K] @ B[K,N] (+ bias[n] · (rowscale ? rowscale[m] : 1)),
// row-major, lda = K, ldb = ldc = N. 64x64 tile, k-step 16, 256 threads,
// a 4x4 block of outputs per thread read as float4 from shared memory; the
// next k-step's tile is fetched into registers while this one is multiplied
// (two shared-memory stages). k runs 0..K-1 in order for every output.
// gridDim.z = 2 runs a second problem on the same A (the two node
// projections) in the same launch.
// ---------------------------------------------------------------------------
constexpr int GM = 64, GN = 64, GK = 16, GT = 256, GPAD = 4;

struct GemmOut {
  const float* B;
  float* C;
  const float* bias;
};

__global__ void __launch_bounds__(GT)
gemm_f32_kernel(const float* __restrict__ A, GemmOut p0, GemmOut p1,
                const float* __restrict__ rowscale, int M, int N, int K) {
  __shared__ __align__(16) float As[2][GK][GM + GPAD];
  __shared__ __align__(16) float Bs[2][GK][GN];
  const GemmOut p = blockIdx.z ? p1 : p0;
  const float* __restrict__ B = p.B;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * GM, n0 = blockIdx.x * GN;
  float acc[4][4] = {};
  float ra[4], rb[4];

  auto fetch = [&](int k0) {
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      const int idx = tid + l * GT;
      const int r = idx / GK, k = idx % GK;          // A: along k
      const int gm = m0 + r, gk = k0 + k;
      ra[l] = (gm < M && gk < K) ? A[(size_t)gm * K + gk] : 0.f;
      const int kb = idx / GN, c = idx % GN;         // B: along n
      const int gkb = k0 + kb, gn = n0 + c;
      rb[l] = (gkb < K && gn < N) ? B[(size_t)gkb * N + gn] : 0.f;
    }
  };
  auto stash = [&](int s) {
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      const int idx = tid + l * GT;
      As[s][idx % GK][idx / GK] = ra[l];
      Bs[s][idx / GN][idx % GN] = rb[l];
    }
  };

  fetch(0);
  stash(0);
  __syncthreads();
  int s = 0;
  for (int k0 = 0; k0 < K; k0 += GK) {
    const bool more = k0 + GK < K;
    if (more) fetch(k0 + GK);
#pragma unroll
    for (int k = 0; k < GK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&As[s][k][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[s][k][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (more) stash(s ^ 1);
    __syncthreads();
    s ^= 1;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty * 4 + i;
    if (gm >= M) continue;
    const float scale = rowscale ? rowscale[gm] : 1.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx * 4 + j;
      if (gn >= N) continue;
      float v = acc[i][j];
      if (p.bias) v += p.bias[gn] * scale;
      p.C[(size_t)gm * N + gn] = v;
    }
  }
}

// One launch, `count` (1 or 2) problems sharing A.
static cudaError_t gemm(const float* A, GemmOut p0, GemmOut p1, int count,
                        const float* rowscale, int M, int N, int K,
                        cudaStream_t s) {
  dim3 grid((N + GN - 1) / GN, (M + GM - 1) / GM, count);
  gemm_f32_kernel<<<grid, GT, 0, s>>>(A, p0, p1, rowscale, M, N, K);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Edge kernel: one CTA per (column tile of block_h, graph); blockDim =
// (block_h, groups). Per window of block_e edges the CTA stages src, dst
// (>= A -> -1) and d2 in shared memory; edge group g walks its contiguous
// share of the window in edge order, thread t of the group adding silu(z)
// into column t of the group's (A x block_h) partial. The partials are
// added in group order at the end. Thread 0 of each group in the CTAs of
// column tile 0 also counts its share's edges per node (exact integers).
// ---------------------------------------------------------------------------
constexpr int EU = 4;   // edges in flight per thread

__global__ void __launch_bounds__(512)
egnn_edge_kernel(const float* __restrict__ Pi, const float* __restrict__ Pj,
                 const float* __restrict__ pos,
                 const int32_t* __restrict__ src,
                 const int32_t* __restrict__ dst,
                 const float* __restrict__ w0d, float* __restrict__ S,
                 float* __restrict__ deg, int A, int E, int H, int block_e) {
  extern __shared__ float smem[];
  const int block_h = blockDim.x, groups = blockDim.y;
  float* acc = smem;                                   // [G][A][block_h]
  float* deg_s = acc + (size_t)groups * A * block_h;   // [G][A]
  float* d2_s = deg_s + groups * A;                    // [block_e]
  int* src_s = reinterpret_cast<int*>(d2_s + block_e); // [block_e]
  int* dst_s = src_s + block_e;                        // [block_e]

  const int tid = threadIdx.x, g = threadIdx.y;
  const int flat = g * block_h + tid, nthreads = groups * block_h;
  const int c = blockIdx.x * block_h + tid;
  const int b = blockIdx.y;
  const bool active = c < H;
  const bool count = blockIdx.x == 0 && tid == 0;
  float* my = acc + (size_t)g * A * block_h;
  float* my_deg = deg_s + g * A;

  for (int a = 0; a < A; ++a) my[a * block_h + tid] = 0.f;
  if (count)
    for (int a = 0; a < A; ++a) my_deg[a] = 0.f;

  const float wd = active ? w0d[c] : 0.f;
  const float* pi = Pi + (size_t)b * A * H + c;
  const float* pj = Pj + (size_t)b * A * H + c;
  const float* pb = pos + (size_t)b * A * 3;
  const int32_t* sr = src + (size_t)b * E;
  const int32_t* dr = dst + (size_t)b * E;

  for (int e0 = 0; e0 < E; e0 += block_e) {
    const int ne = min(block_e, E - e0);
    __syncthreads();                       // previous window consumed
    for (int i = flat; i < ne; i += nthreads) {
      const int d = dr[e0 + i];
      const int s = min(sr[e0 + i], A - 1);          // clamped gather
      const int dc = min(d, A - 1);
      const float dx = pb[s * 3 + 0] - pb[dc * 3 + 0];
      const float dy = pb[s * 3 + 1] - pb[dc * 3 + 1];
      const float dz = pb[s * 3 + 2] - pb[dc * 3 + 2];
      d2_s[i] = dx * dx + dy * dy + dz * dz;
      src_s[i] = s;
      dst_s[i] = (d >= 0 && d < A) ? d : -1;
    }
    __syncthreads();
    const int share = (ne + groups - 1) / groups;
    const int lo = min(ne, g * share), hi = min(ne, lo + share);
    if (count)
      for (int i = lo; i < hi; ++i)
        if (dst_s[i] >= 0) my_deg[dst_s[i]] += 1.f;
    if (!active) continue;
    int i = lo;
    for (; i + EU <= hi; i += EU) {
      int d[EU];
      float v[EU];
#pragma unroll
      for (int u = 0; u < EU; ++u) {
        d[u] = dst_s[i + u];
        v[u] = 0.f;
        if (d[u] >= 0) {
          const float z = pi[(size_t)src_s[i + u] * H] + pj[(size_t)d[u] * H] +
                          d2_s[i + u] * wd;
          v[u] = z / (1.f + expf(-z));               // silu
        }
      }
#pragma unroll
      for (int u = 0; u < EU; ++u)
        if (d[u] >= 0) my[d[u] * block_h + tid] += v[u];
    }
    for (; i < hi; ++i) {
      const int d = dst_s[i];
      if (d < 0) continue;
      const float z = pi[(size_t)src_s[i] * H] + pj[(size_t)d * H] +
                      d2_s[i] * wd;
      my[d * block_h + tid] += z / (1.f + expf(-z));
    }
  }
  __syncthreads();
  for (int a = g; a < A; a += groups) {
    if (active) {
      float v = 0.f;
      for (int q = 0; q < groups; ++q) v += acc[((size_t)q * A + a) * block_h + tid];
      S[((size_t)b * A + a) * H + c] = v;
    }
    if (blockIdx.x == 0 && tid == 0) {
      float n = 0.f;
      for (int q = 0; q < groups; ++q) n += deg_s[q * A + a];
      deg[(size_t)b * A + a] = n;
    }
  }
}

// h (B,A,H), pos (B,A,3) f32; src/dst (B,E) int32, dst >= A for edges that
// contribute nothing; w0 the whole fc0 weight (2H+1, H) = [w0i; w0j; w0d];
// b0, b1 (H,); w1 (H,H); out (B,A,H). Scratch from the caller: Pi, Pj, S
// (B,A,H) and deg (B,A). All f32, contiguous. block_h x groups <= 512.
extern "C" int egnn_edge_fwd_launch(const float* h, const float* pos,
                                    const int32_t* src, const int32_t* dst,
                                    const float* w0, const float* b0,
                                    const float* w1, const float* b1,
                                    float* out, float* Pi, float* Pj,
                                    float* S, float* deg, int B, int A,
                                    int E, int H, int block_e, int block_h,
                                    int groups, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * A;
  const float* w0i = w0;
  const float* w0j = w0 + (size_t)H * H;
  const float* w0d = w0 + (size_t)2 * H * H;
  cudaError_t err = gemm(h, GemmOut{w0i, Pi, b0}, GemmOut{w0j, Pj, nullptr},
                         2, nullptr, M, H, H, s);
  if (err != cudaSuccess) return (int)err;

  const size_t smem =
      ((size_t)groups * (A * block_h + A) + block_e) * sizeof(float) +
      (size_t)2 * block_e * sizeof(int);
  err = allow_smem(egnn_edge_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((H + block_h - 1) / block_h, B);
  dim3 block(block_h, groups);
  egnn_edge_kernel<<<grid, block, smem, s>>>(Pi, Pj, pos, src, dst, w0d, S,
                                             deg, A, E, H, block_e);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const GemmOut fc1{w1, out, b1};
  return (int)gemm(S, fc1, fc1, 1, deg, M, H, H, s);
}
