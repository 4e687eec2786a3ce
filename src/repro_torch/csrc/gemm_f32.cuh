// Node-level fp32 GEMM shared by the fused EGNN edge kernels (forward and
// backward): plain IEEE fp32 FFMA from shared-memory tiles, no TF32, mma or
// wgmma, so it keeps the plain PyTorch version's fp32 accuracy.
//
//   C[M,N] = sum_t op(A_t)[M,K] @ op(B_t)[K,N]  (+ bias[n] * rowscale[m])
//
// op(A) is A (stored M x K row-major) or, with TA, the transpose of a stored
// K x M matrix; a null A_t stands for a matrix of ones (column sums). op(B)
// is B (stored K x N) or, with TB, the transpose of a stored N x K matrix.
// `terms` (1 or 2) products are summed in one accumulator: term 0's k from 0
// to K-1, then term 1's, the same order for every output, so a result
// depends on the shapes alone, never on timing. One launch runs up to three
// products of the same N and K (gridDim.z), each with its own M.
//
// 64x64 output tile, k-step 16, 256 threads, a 4x4 block of outputs per
// thread read as float4 from shared memory; the next k-step's tile is
// fetched into registers while this one is multiplied (two shared stages).
// Tiles are loaded along the stored matrix's rows whichever way it is
// transposed, so neighbouring threads read neighbouring addresses; both
// shared tiles are padded by 4 floats a row, so a transposed tile's store
// (16 threads down one column) spreads over the banks.
#pragma once

#include "common.cuh"

constexpr int GM = 64, GN = 64, GK = 16, GT = 256, GPAD = 4;

struct GemmProb {
  const float* A[2];
  const float* B[2];
  float* C;
  const float* bias;       // (N,) or null
  const float* rowscale;   // (M,) or null: bias[n] * rowscale[m]
  int M;
  int terms;
};

struct GemmBatch {
  GemmProb p[3];
};

// One product, one term.
static inline GemmProb gemm_prob(const float* A, const float* B, float* C,
                                 int M, const float* bias = nullptr,
                                 const float* rowscale = nullptr) {
  GemmProb p;
  p.A[0] = A;
  p.A[1] = nullptr;
  p.B[0] = B;
  p.B[1] = nullptr;
  p.C = C;
  p.bias = bias;
  p.rowscale = rowscale;
  p.M = M;
  p.terms = 1;
  return p;
}

template <bool TA, bool TB>
__global__ void __launch_bounds__(GT)
gemm_f32_kernel(GemmBatch batch, int N, int K) {
  __shared__ __align__(16) float As[2][GK][GM + GPAD];
  __shared__ __align__(16) float Bs[2][GK][GN + GPAD];
  const GemmProb p = blockIdx.z == 0 ? batch.p[0]
                     : blockIdx.z == 1 ? batch.p[1] : batch.p[2];
  const int M = p.M;
  const int m0 = blockIdx.y * GM, n0 = blockIdx.x * GN;
  if (m0 >= M) return;                 // a shorter product of the launch
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int ksteps = (K + GK - 1) / GK;
  const int steps = ksteps * p.terms;
  float acc[4][4] = {};
  float ra[4], rb[4];

  // (row, k) of A's and (k, col) of B's tile element `idx`, along the
  // stored matrix's contiguous dimension
  auto a_at = [&](int idx, int& r, int& k) {
    if (TA) {
      k = idx / GM; r = idx % GM;
    } else {
      r = idx / GK; k = idx % GK;
    }
  };
  auto b_at = [&](int idx, int& kb, int& c) {
    if (TB) {
      c = idx / GK; kb = idx % GK;
    } else {
      kb = idx / GN; c = idx % GN;
    }
  };
  auto fetch = [&](int t, int k0) {             // term t, k-step at k0
    const float* __restrict__ A = t ? p.A[1] : p.A[0];
    const float* __restrict__ B = t ? p.B[1] : p.B[0];
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      const int idx = tid + l * GT;
      int r, k, kb, c;
      a_at(idx, r, k);
      b_at(idx, kb, c);
      const int gm = m0 + r, gk = k0 + k;
      float a = 0.f;
      if (gm < M && gk < K)
        a = A == nullptr ? 1.f
            : TA ? A[(size_t)gk * M + gm] : A[(size_t)gm * K + gk];
      ra[l] = a;
      const int gkb = k0 + kb, gn = n0 + c;
      rb[l] = (gkb < K && gn < N)
                  ? (TB ? B[(size_t)gn * K + gkb] : B[(size_t)gkb * N + gn])
                  : 0.f;
    }
  };
  auto stash = [&](int s) {
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      const int idx = tid + l * GT;
      int r, k, kb, c;
      a_at(idx, r, k);
      b_at(idx, kb, c);
      As[s][k][r] = ra[l];
      Bs[s][kb][c] = rb[l];
    }
  };

  fetch(0, 0);
  stash(0);
  __syncthreads();
  int s = 0, t = 0, k0 = 0;
  for (int step = 0; step < steps; ++step) {
    int tn = t, kn = k0 + GK;                  // the next k-step
    if (kn >= K) {
      kn = 0;
      ++tn;
    }
    const bool more = step + 1 < steps;
    if (more) fetch(tn, kn);
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
    t = tn;
    k0 = kn;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty * 4 + i;
    if (gm >= M) continue;
    const float scale = p.rowscale ? p.rowscale[gm] : 1.f;
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

// `count` (1 to 3) products of `batch` in one launch; max_m is the largest M.
template <bool TA, bool TB>
static cudaError_t gemm(const GemmBatch& batch, int count, int max_m, int N,
                        int K, cudaStream_t s) {
  dim3 grid((N + GN - 1) / GN, (max_m + GM - 1) / GM, count);
  gemm_f32_kernel<TA, TB><<<grid, GT, 0, s>>>(batch, N, K);
  return cudaGetLastError();
}
