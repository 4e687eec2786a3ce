// Node-level GEMMs of the bf16 EGNN edge forward (#3 in bf16) on Hopper's
// tensor cores: bf16 operands, f32 accumulators, one or two products of one
// shape in a launch.
//
//   C[M,N] = A[M,K] @ B[K,N] (+ bias[c], or + row_scale[r]·bias[c])
//
// A is stored M x K (row stride lda, k contiguous), in bf16 or in f32 (then
// rounded to bf16, to nearest, as it is staged: the forward's S); B is a
// bf16 weight stored K x N (row stride ldb, n contiguous), the bias a bf16
// leaf, the row scale f32 (deg); the epilogue runs in f32. C is written in
// f32 (Pi, Pj: scratch the edge kernel and the backward read) or rounded
// once to bf16 (the output).
//
// Tensor cores: wgmma.mma_async m64n128k16 (bf16 x bf16 -> f32), both
// operands from shared memory. A CTA of two warpgroups computes 128 x 128
// outputs, each warpgroup 64 x 128 (64 f32 accumulators a thread), over
// k-steps of 64: four MMAs a step. A is staged K-major (128 rows of 128 B,
// 64 bf16 along k); B is staged as it lies in memory, MN-major (64 k-rows
// of 256 B, two 64-column halves), and read through the MMA's transpose
// bit, so no thread transposes it. Both in the 128-byte swizzle (16-byte
// chunk c of row r at c ^ (r % 8)), which spreads every warp's stores over
// all banks.
//
// Feed: operands are staged through registers, 16-byte pieces each thread
// loads for the k-step after next while the tensor cores work, with the
// widest loads the pointers, strides and extents allow; the words stay as
// loaded (S's f32 is rounded to bf16 only as it is stored to shared memory)
// so that no instruction waits on a load before the next MMAs issue. At
// H = 866 a bf16 row is 1732 B, not a multiple of 16, so neither TMA nor
// 16-byte loads can address the unpadded h, w or S rows: loads are 4 bytes
// (8 for S in f32), and nothing is padded or copied.
// Past K both operands are zero (K = 866 leaves a k-step of 34 in 64);
// rows past M or N only reach outputs that are never stored.
// Three stages of 32 KB: a stage is filled while the one before it
// multiplies and the MMAs of the one before that finish (wgmma.wait_group
// 1). One accumulator runs over the whole K: the tensor cores' truncating
// accumulation costs ~1e-5 of a result over K = 2560 (PERF.md), less at
// K = 866, far inside a bf16 tolerance, so there is no f32 fold.
//
// Launch: one CTA per item, each product's (m-tile, n-tile) in product
// order; no split-K: gemm_plan.py's ITEM_KSTEPS was fitted to the 3xTF32
// GEMM's k-steps, a bf16 k-step costs differently, and no split plan has
// been fitted to it. Every output is written once, its sum over k in k
// order: the bits depend on the shapes alone (as serving's rows, bitwise
// to predict_one, need).
#pragma once

#include "common.cuh"
#include "gemm_tc.cuh"

namespace bf {
constexpr int BM = 128, BN = 128, BK = 64;
constexpr int STAGES = 3;
constexpr int THREADS = 256;
constexpr int TILE = 128 * 128;      // bytes of an A tile and of a B tile
constexpr int STAGE = 2 * TILE;      // A, then B
constexpr int B_HALF = BK * 128;     // bytes between B's two column halves
constexpr size_t SMEM_BYTES = (size_t)STAGES * STAGE + 1024;  // + alignment
constexpr int MAX_PROBS = 2;
}  // namespace bf

struct BfProb {
  const void* A;           // M x K: bf16, or f32 with a_f32
  const __nv_bfloat16* B;  // K x N
  void* C;                 // M x N: f32, or bf16 with c_bf16
  const __nv_bfloat16* bias;  // + bias[c], or + row_scale[r]·bias[c];
  const float* row_scale;     // null: none
  int M, N, K, lda, ldb;
  int a_f32, c_bf16;
  int lvec_a, lvec_b;      // log2 of the elements a load moves
  int tiles_m, tiles_n;
};

struct BfLaunch {
  BfProb p[bf::MAX_PROBS];
  int item_end[bf::MAX_PROBS];   // cumulative items
  int count;
};

namespace bf {

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// B (MN-major, 128-byte swizzle): 8-row groups of k 1024 B apart (SBO), the
// two 64-column halves B_HALF apart (LBO).
__device__ __forceinline__ uint64_t desc_b(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)(B_HALF >> 4) << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// D (64 x 128 of the warpgroup) += A (64 x 16, K-major) · B (16 x 128,
// MN-major: the transpose bit), both in shared memory
__device__ __forceinline__ void wgmma_bf16(float (&d)[64], uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// Eight consecutive values X[at + j] (j < 8), each zero where pos + j >=
// extent; `pos` is a multiple of 8 and loads move 2^lvec values (extent a
// multiple of that, so a load is all in or out). The words are kept as
// they arrive, so that nothing waits on a load before store_step, after
// the next k-step's MMAs are issued: bf16 pairs (load8_bf16) or f32 bits
// (load8_f32, rounded to bf16 pairs by store_step).
__device__ __forceinline__ uint4 load8_bf16(const void* X, size_t at,
                                            int lvec, int pos, int extent) {
  const uint16_t* s = static_cast<const uint16_t*>(X) + at;
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  if (lvec >= 3) {
    if (pos < extent) {
      const uint4 x = *reinterpret_cast<const uint4*>(s);
      w[0] = x.x; w[1] = x.y; w[2] = x.z; w[3] = x.w;
    }
  } else if (lvec == 2) {
#pragma unroll
    for (int q = 0; q < 4; q += 2)
      if (pos + 2 * q < extent) {
        const uint2 x = *reinterpret_cast<const uint2*>(s + 2 * q);
        w[q] = x.x; w[q + 1] = x.y;
      }
  } else if (lvec == 1) {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (pos + 2 * q < extent)
        w[q] = *reinterpret_cast<const uint32_t*>(s + 2 * q);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (pos + j < extent) w[j / 2] |= (uint32_t)s[j] << (16 * (j & 1));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ void load8_f32(const void* X, size_t at, int lvec,
                                          int pos, int extent,
                                          uint32_t (&w)[8]) {
  const float* s = static_cast<const float*>(X) + at;
#pragma unroll
  for (int j = 0; j < 8; ++j) w[j] = 0u;
  if (lvec >= 2) {
#pragma unroll
    for (int j = 0; j < 8; j += 4)
      if (pos + j < extent) {
        const uint4 x = *reinterpret_cast<const uint4*>(s + j);
        w[j] = x.x; w[j + 1] = x.y; w[j + 2] = x.z; w[j + 3] = x.w;
      }
  } else if (lvec == 1) {
#pragma unroll
    for (int j = 0; j < 8; j += 2)
      if (pos + j < extent) {
        const uint2 x = *reinterpret_cast<const uint2*>(s + j);
        w[j] = x.x; w[j + 1] = x.y;
      }
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (pos + j < extent) w[j] = __float_as_uint(s[j]);
  }
}

// This thread's four 16-byte pieces of k-step `step`: of A, (row, 8-k
// chunk) — 8 threads read one row's 64 k; of B, (k-row, 8-column chunk) —
// 16 threads read one k-row's 128 columns. A's words: va[i][0..3] bf16
// pairs, or va[i][0..7] f32 bits.
__device__ __forceinline__ void load_step(const BfProb& P, int step, int m0,
                                          int n0, uint32_t (&va)[4][8],
                                          uint4 (&vb)[4]) {
  const int k0 = step * BK;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int item = threadIdx.x + i * THREADS;
    const int r = item >> 3, k = k0 + 8 * (item & 7);
    const size_t at = (size_t)(m0 + r) * P.lda + k;
    if (m0 + r >= P.M) {
#pragma unroll
      for (int j = 0; j < 8; ++j) va[i][j] = 0u;
    } else if (P.a_f32) {
      load8_f32(P.A, at, P.lvec_a, k, P.K, va[i]);
    } else {
      const uint4 x = load8_bf16(P.A, at, P.lvec_a, k, P.K);
      va[i][0] = x.x; va[i][1] = x.y; va[i][2] = x.z; va[i][3] = x.w;
    }
    const int kr = k0 + (item >> 4), n = n0 + 8 * (item & 15);
    vb[i] = kr < P.K ? load8_bf16(P.B, (size_t)kr * P.ldb + n, P.lvec_b, n,
                                  P.N)
                     : make_uint4(0u, 0u, 0u, 0u);
  }
}

__device__ __forceinline__ void store_step(unsigned char* st,
                                           const BfProb& P,
                                           const uint32_t (&va)[4][8],
                                           const uint4 (&vb)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int item = threadIdx.x + i * THREADS;
    const int r = item >> 3, kc = item & 7;
    uint4 a;
    if (P.a_f32) {
      a.x = pack(__uint_as_float(va[i][0]), __uint_as_float(va[i][1]));
      a.y = pack(__uint_as_float(va[i][2]), __uint_as_float(va[i][3]));
      a.z = pack(__uint_as_float(va[i][4]), __uint_as_float(va[i][5]));
      a.w = pack(__uint_as_float(va[i][6]), __uint_as_float(va[i][7]));
    } else {
      a = make_uint4(va[i][0], va[i][1], va[i][2], va[i][3]);
    }
    *reinterpret_cast<uint4*>(st + r * 128 + ((kc ^ (r & 7)) << 4)) = a;
    const int kr = item >> 4, nc = item & 15;
    *reinterpret_cast<uint4*>(st + TILE + (nc >> 3) * B_HALF + kr * 128 +
                              (((nc & 7) ^ (kr & 7)) << 4)) = vb[i];
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Issue the stage's 4 MMAs (k16 each); with `fresh` the first one
// overwrites the accumulator.
__device__ __forceinline__ void mma_stage(const unsigned char* st,
                                          float (&d)[64], bool fresh) {
  const uint32_t a = tc::smem_addr(st) + (threadIdx.x >> 7) * 64 * 128;
  const uint32_t b = tc::smem_addr(st) + TILE;
  tc::fence_acc(d);
  tc::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wgmma_bf16(d, tc::desc(a + kk * 32), desc_b(b + kk * 2048),
               !fresh || kk);
  tc::wgmma_commit();
  tc::fence_acc(d);
}

__device__ void tile(const BfProb& P, int item, unsigned char* smem) {
  const int tm = item / P.tiles_n, tn = item - tm * P.tiles_n;
  const int m0 = tm * BM, n0 = tn * BN;
  const int steps = (P.K + BK - 1) / BK;

  float d[64];                       // the first MMA overwrites it
  uint32_t va[4][8];
  uint4 vb[4];
  if (steps > 0) {
    load_step(P, 0, m0, n0, va, vb);
    store_step(smem, P, va, vb);
  }
  if (steps > 1) load_step(P, 1, m0, n0, va, vb);
  for (int s = 0; s < steps; ++s) {
    __syncthreads();                   // stage s is stored; s-2 is done
    mma_stage(smem + (s % STAGES) * STAGE, d, s == 0);
    tc::wgmma_wait<1>();               // step s-1's MMAs are done
    if (s + 1 < steps)
      store_step(smem + ((s + 1) % STAGES) * STAGE, P, va, vb);
    if (s + 2 < steps) load_step(P, s + 2, m0, n0, va, vb);
  }
  tc::wgmma_wait<0>();
  tc::fence_acc(d);
  if (steps == 0) {
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = 0.f;
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  auto store = [&](int r, int c, float x) {
    if (r >= P.M || c >= P.N) return;
    if (P.bias != nullptr) {
      const float b = __bfloat162float(P.bias[c]);
      x = P.row_scale != nullptr ? fmaf(P.row_scale[r], b, x) : x + b;
    }
    const size_t o = (size_t)r * P.N + c;
    if (P.c_bf16)
      static_cast<__nv_bfloat16*>(P.C)[o] = __float2bfloat16_rn(x);
    else
      static_cast<float*>(P.C)[o] = x;
  };
  const int r = m0 + (warp >> 2) * 64 + (warp & 3) * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c = n0 + j * 8 + 2 * (lane & 3);
    store(r, c, d[4 * j]);
    store(r, c + 1, d[4 * j + 1]);
    store(r + 8, c, d[4 * j + 2]);
    store(r + 8, c + 1, d[4 * j + 3]);
  }
}

}  // namespace bf

__global__ void __launch_bounds__(bf::THREADS, 1)
gemm_bf16_kernel(const __grid_constant__ BfLaunch L) {
  extern __shared__ __align__(16) unsigned char bf_raw[];
  // the swizzled tiles need 1024-byte alignment
  unsigned char* smem = bf_raw + ((1024 - (tc::smem_addr(bf_raw) & 1023)) &
                                  1023);
  int item = blockIdx.x, p = 0;
  while (p + 1 < L.count && item >= L.item_end[p]) ++p;
  bf::tile(L.p[p], item - (p ? L.item_end[p - 1] : 0), smem);
}

// A product for `gemm_bf16`: C = A·B, A M x K, B K x N, dense row strides.
static inline BfProb bf_prob(const void* A, bool a_f32,
                             const __nv_bfloat16* B, void* C, bool c_bf16,
                             int M, int N, int K) {
  BfProb p{};
  p.A = A;
  p.B = B;
  p.C = C;
  p.a_f32 = a_f32;
  p.c_bf16 = c_bf16;
  p.M = M;
  p.N = N;
  p.K = K;
  p.lda = K;
  p.ldb = N;
  return p;
}

// Launch `L.count` products; fills in tiles, item ranges and load widths.
static cudaError_t gemm_bf16(BfLaunch& L, cudaStream_t s) {
  cudaError_t err =
      allow_smem_once((const void*)gemm_bf16_kernel, bf::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  int items = 0;
  for (int i = 0; i < L.count; ++i) {
    BfProb& p = L.p[i];
    p.tiles_m = (p.M + bf::BM - 1) / bf::BM;
    p.tiles_n = (p.N + bf::BN - 1) / bf::BN;
    // loads of up to 16 bytes: 8 bf16 or 4 f32 values
    p.lvec_a = p.a_f32 ? tc_lvec(p.A, p.lda, p.K, 4)
                       : tc_lvec(p.A, p.lda, p.K, 2, 3);
    p.lvec_b = tc_lvec(p.B, p.ldb, p.N, 2, 3);
    items += p.tiles_m * p.tiles_n;
    L.item_end[i] = items;
  }
  if (items == 0) return cudaSuccess;
  gemm_bf16_kernel<<<items, bf::THREADS, bf::SMEM_BYTES, s>>>(L);
  return cudaGetLastError();
}
