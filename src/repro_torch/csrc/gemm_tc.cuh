// Node-level fp32 GEMMs on Hopper's tensor cores at fp32 accuracy (3xTF32),
// several products of different shapes and transposes in one launch.
//
//   C[M,N] = sum_t op(A_t)[M,K] @ op(B_t)[K,N]
//
// op(A) is A (stored M x K, row stride lda) or, with `ta`, the transpose of
// a stored K x M matrix; op(B) is B (stored K x N) or, with `tb`, the
// transpose of a stored N x K matrix. A kernel instantiation takes one
// family of layouts: MIXED (ta xor tb: the backward's products, #4) or NN
// (neither: the forward's h·w products, #3). `terms` (1 or 2) products
// share one accumulator: term 0's k-steps, then term 1's. A transposed A
// may carry one more row, row M of op(A) = `extra` (a K-vector; null:
// ones), written to `C_extra` — a bias gradient (degᵀ·g, 1ᵀ·dP) rides on
// the weight gradient's tiles for free. NN products may carry an epilogue
// applied to each finished sum: + bias[c] (a column bias), or
// + row_scale[r]·bias[c] (a row-scaled bias, one fma). With `splits` > 1
// the k-steps are cut into that many contiguous ranges, each written as a
// partial (splits, M(+1), N) into C; reduce items (of a later launch) sum
// them in split order and apply the epilogue there — or the caller's own
// kernel sums them.
//
// Operands are f32 or bf16 (a_bf16, b_bf16: #4 takes the trunk's bf16 h,
// the cotangent g of a bf16 output and the bf16 weights as they are), read
// as they lie and converted to f32 in registers where they are staged; a
// bf16 value is exact in f32 and in TF32 (its lo part below is zero), so a
// product of bf16 operands gives the bits of the same product of their f32
// copies. No MMA is skipped for a zero lo part.
//
// Precision: each operand element x is split into two TF32 values,
// hi = cvt.rna.tf32(x), lo = cvt.rna.tf32(x - hi), and every k-step of 8
// runs lo·hi, hi·lo, hi·hi (small terms first). The dropped lo·lo term and
// lo's rounding are ~2^-22 of each product (TF32 alone keeps ~2^-11). The
// tensor cores truncate as they accumulate, which over K = 2560 (~960
// MMAs into one accumulator) costs ~1e-5 of the result, so every FOLD = 2
// k-steps of 32 (24 MMAs) the accumulator is added into an f32 register
// sum with round-to-nearest and starts afresh: a result keeps fp32's
// accuracy, the port's contract that fp32 GEMMs run without TF32.
//
// Tensor cores: wgmma.mma_async m64n128k8 (tf32), both operands from
// shared memory. A CTA of two warpgroups computes 128 x 128 outputs, each
// warpgroup 64 x 128 (64 f32 accumulators a thread), over k-steps of 32.
// wgmma reads tf32 operands only K-major, and four of the backward's six
// products read A and B transposed (the forward's read B = w along n), so
// both are staged through registers: each thread loads 4 x 4 values of
// each operand for the k-step after next while the tensor cores work
// (coalesced: along k where k is contiguous, else along m or n), splits
// them and stores hi and lo as 16-byte pieces of four K-major tiles in the
// 128-byte swizzle (chunk c of row r at c ^ (r % 8)), which spreads every
// warp's stores over all banks.
// Three stages of 64 KB: a stage is filled while the one before it
// multiplies and the MMAs of the one before that finish (wgmma.wait_group
// 1), so staging overlaps the tensor cores except at a fold (wait_group
// 0). The accumulator and the f32 sum take 128 registers a thread, so one
// CTA an SM; with no second CTA to fill the gaps, the barrier every k-step
// and each fold's drain leave the tensor cores idle much of the time
// (PERF.md). Past the K edge both operands are zero; rows past M or N only
// reach outputs that are never stored.
//
// Launch: one CTA per item. Items are the reduce items first, then each
// product's (split, m-tile, n-tile) in product order — the host orders the
// products longest k-range first. No atomics: every output element is
// written once, its sum over k in one fixed order (k-steps in order, then
// splits in order) that depends on the shapes and the split count alone.
// kernels/egnn_edge/gemm_plan.py mirrors this item layout.
#pragma once

#include "common.cuh"

namespace tc {
constexpr int BM = 128, BN = 128, BK = 32;
constexpr int STAGES = 3;
constexpr int FOLD = 2;              // k-steps an accumulator spans
constexpr int THREADS = 256;
constexpr int TILE = 128 * BK * 4;   // bytes: 128 K-major rows of 128 B
constexpr int STAGE = 4 * TILE;      // A hi, A lo, B hi, B lo
constexpr size_t SMEM_BYTES = (size_t)STAGES * STAGE + 1024;  // + alignment
constexpr int MAX_PROBS = 6;
constexpr int REDUCE_ELEMS = 65536;  // partial elements a reduce item sums
enum Layout { MIXED = 0, NN = 1 };   // the products a kernel takes
}  // namespace tc

struct TcProb {
  const void* A[2];        // f32, or bf16 with a_bf16
  const void* B[2];        // f32, or bf16 with b_bf16
  const float* extra;  // ta && has_extra: row M of op(A); null: ones
  const float* bias;       // NN epilogue (splits == 1): + bias[c], or
  const float* row_scale;  // + row_scale[r]·bias[c]; null: none
  float* C;            // (M, N); splits > 1: (splits, M + has_extra, N)
  float* C_extra;      // (N,): row M (splits == 1)
  int M, N, K, lda, ldb;
  int terms, ta, tb, has_extra, splits;
  int a_bf16, b_bf16;
  int lvec_a, lvec_b;  // log2 of the values a load of k-contiguous rows moves
  int tiles_m, tiles_n;
};

struct TcReduce {      // C(+C_extra) = sum over s of part[s], s in order
  const float* part;   // (splits, M + 1, N) with C_extra, else (splits, M, N)
  float* C;
  float* C_extra;
  const float* bias;       // the product's epilogue on C, as in TcProb
  const float* row_scale;
  int M, N, splits, items;
  int elems;           // partial elements an item sums
};

struct TcLaunch {
  TcProb p[tc::MAX_PROBS];
  int item_end[tc::MAX_PROBS];   // cumulative items, reduce items excluded
  int count;
  TcReduce red;
};

namespace tc {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// A K-major tile in the 128-byte swizzle: rows of 128 B (32 tf32 along
// k), 8-row groups 1024 B apart.
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// D (64 x 128 of the warpgroup) += A (64 x 8) · B (8 x 128), both K-major
// in shared memory
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
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

// This thread's four (row, 4-k chunk) pieces of an operand's k-step:
// where k is contiguous in memory 8 threads read one row's 32 k, else 32
// threads read 32 contiguous rows of one k.
template <bool KCONTIG>
__device__ __forceinline__ void piece(int i, int& r, int& kc) {
  const int item = threadIdx.x + i * THREADS;
  if (KCONTIG) {
    r = item >> 3;
    kc = item & 7;
  } else {
    r = item & 127;
    kc = item >> 7;
  }
}

// An operand as rows x K: element (row, k) at X[row·ld + k] (KCONTIG) or
// X[k·ld + row], f32 or (bf) bf16; `rows` rows are stored, and row
// `extra_row` (-1: none) is `extra` (null: ones; with bf, ones only). Values
// past K are zero. The loaded words are kept as they arrive (f32 bits; a
// bf16 value zero-extended, or two bf16 values packed when `packed`:
// bf, KCONTIG and lvec >= 1), so that nothing waits on a load before
// store_op converts them, after the next k-step's MMAs are issued.
template <bool KCONTIG>
__device__ __forceinline__ void load_op(const void* __restrict__ X, bool bf,
                                        int ld, int lvec, int row0, int rows,
                                        int k0, int K, const float* extra,
                                        int extra_row,
                                        uint32_t (&v)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int r, kc;
    piece<KCONTIG>(i, r, kc);
    const int gr = row0 + r, k = k0 + 4 * kc;
#pragma unroll
    for (int j = 0; j < 4; ++j) v[i][j] = 0u;
    if (gr == extra_row) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (k + j < K) {
          const uint32_t e =
              __float_as_uint(extra != nullptr ? extra[k + j] : 1.f);
          v[i][j] = bf ? e >> 16 : e;
        }
    } else if (gr < rows && bf) {
      const uint16_t* x16 = static_cast<const uint16_t*>(X);
      if (KCONTIG) {
        const uint16_t* src = x16 + (size_t)gr * ld + k;
        if (lvec == 2) {
          if (k < K) {
            const uint2 x = *reinterpret_cast<const uint2*>(src);
            v[i][0] = x.x;
            v[i][1] = x.y;
          }
        } else if (lvec == 1) {
#pragma unroll
          for (int j = 0; j < 4; j += 2)
            if (k + j < K)
              v[i][j / 2] = *reinterpret_cast<const uint32_t*>(src + j);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (k + j < K) v[i][j] = src[j];
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (k + j < K) v[i][j] = x16[(size_t)(k + j) * ld + gr];
      }
    } else if (gr < rows) {
      const float* x32 = static_cast<const float*>(X);
      if (KCONTIG) {
        const float* src = x32 + (size_t)gr * ld + k;
        if (lvec == 2) {
          if (k < K) {
            const uint4 x = *reinterpret_cast<const uint4*>(src);
            v[i][0] = x.x; v[i][1] = x.y; v[i][2] = x.z; v[i][3] = x.w;
          }
        } else if (lvec == 1) {
#pragma unroll
          for (int j = 0; j < 4; j += 2)
            if (k + j < K) {
              const uint2 x = *reinterpret_cast<const uint2*>(src + j);
              v[i][j] = x.x;
              v[i][j + 1] = x.y;
            }
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (k + j < K) v[i][j] = __float_as_uint(src[j]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (k + j < K)
            v[i][j] = __float_as_uint(x32[(size_t)(k + j) * ld + gr]);
      }
    }
  }
}

// The pieces' words as f32 values, split; hi and lo stored into a K-major
// tile pair.
template <bool KCONTIG>
__device__ __forceinline__ void store_op(unsigned char* hi_tile,
                                         const uint32_t (&v)[4][4], bool bf,
                                         int lvec) {
  const bool packed = bf && KCONTIG && lvec >= 1;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int r, kc;
    piece<KCONTIG>(i, r, kc);
    const int off = r * 128 + ((kc ^ (r & 7)) << 4);
    float x[4];
    if (packed) {
      x[0] = __uint_as_float(v[i][0] << 16);
      x[1] = __uint_as_float(v[i][0] & 0xffff0000u);
      x[2] = __uint_as_float(v[i][1] << 16);
      x[3] = __uint_as_float(v[i][1] & 0xffff0000u);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        x[j] = __uint_as_float(bf ? v[i][j] << 16 : v[i][j]);
    }
    uint4 hi, lo;
    split(x[0], hi.x, lo.x);
    split(x[1], hi.y, lo.y);
    split(x[2], hi.z, lo.z);
    split(x[3], hi.w, lo.w);
    *reinterpret_cast<uint4*>(hi_tile + off) = hi;
    *reinterpret_cast<uint4*>(hi_tile + TILE + off) = lo;
  }
}

template <bool TA, bool TB>
__device__ __forceinline__ void load_step(const TcProb& P, int step, int nk,
                                          int m0, int n0,
                                          uint32_t (&va)[4][4],
                                          uint32_t (&vb)[4][4]) {
  const int term = step / nk, k0 = (step - term * nk) * BK;
  load_op<!TA>(P.A[term], P.a_bf16, P.lda, P.lvec_a, m0, P.M, k0, P.K,
               P.extra, P.has_extra ? P.M : -1, va);
  load_op<TB>(P.B[term], P.b_bf16, P.ldb, P.lvec_b, n0, P.N, k0, P.K,
              nullptr, -1, vb);
}

template <bool TA, bool TB>
__device__ __forceinline__ void store_step(unsigned char* st,
                                           const TcProb& P,
                                           const uint32_t (&va)[4][4],
                                           const uint32_t (&vb)[4][4]) {
  store_op<!TA>(st, va, P.a_bf16, P.lvec_a);
  store_op<TB>(st + 2 * TILE, vb, P.b_bf16, P.lvec_b);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Keeps the compiler from moving an accumulator while MMAs are in flight.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Issue the stage's 12 MMAs (4 k-steps of 8 x lo·hi, hi·lo, hi·hi); with
// `fresh` the first one overwrites the accumulator.
__device__ __forceinline__ void mma_stage(const unsigned char* st,
                                          float (&d)[64], bool fresh) {
  const uint32_t base = smem_addr(st);
  const uint32_t ah = base + (threadIdx.x >> 7) * 64 * 128, al = ah + TILE;
  const uint32_t bh = base + 2 * TILE, bl = bh + TILE;
  fence_acc(d);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk) {
    wgmma_tf32(d, desc(al + kk * 32), desc(bh + kk * 32), !fresh || kk);
    wgmma_tf32(d, desc(ah + kk * 32), desc(bl + kk * 32), 1);
    wgmma_tf32(d, desc(ah + kk * 32), desc(bh + kk * 32), 1);
  }
  wgmma_commit();
  fence_acc(d);
}

// A finished sum of output (r, c) through its product's epilogue.
__device__ __forceinline__ float epilogue(const float* bias,
                                          const float* row_scale, int r,
                                          int c, float x) {
  if (bias == nullptr) return x;
  return row_scale != nullptr ? fmaf(row_scale[r], bias[c], x) : x + bias[c];
}

template <bool TA, bool TB, bool EPI>
__device__ void tile(const TcProb& P, int item, unsigned char* smem) {
  const int per_split = P.tiles_m * P.tiles_n;
  const int split = item / per_split;
  const int rest = item - split * per_split;
  const int tm = rest / P.tiles_n, tn = rest - tm * P.tiles_n;
  const int m0 = tm * BM, n0 = tn * BN;
  const int nk = (P.K + BK - 1) / BK;
  const int total = P.terms * nk;
  const int per = (total + P.splits - 1) / P.splits;
  const int s0 = min(total, split * per);
  const int steps = min(total, s0 + per) - s0;

  // Every FOLD k-steps the MMAs' accumulator d is added into `acc` in f32
  // and starts afresh, so the tensor cores' truncating accumulation never
  // spans more than FOLD k-steps.
  float d[64], acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  uint32_t va[4][4], vb[4][4];
  if (steps > 0) {
    load_step<TA, TB>(P, s0, nk, m0, n0, va, vb);
    store_step<TA, TB>(smem, P, va, vb);
  }
  if (steps > 1) load_step<TA, TB>(P, s0 + 1, nk, m0, n0, va, vb);
  for (int s = 0; s < steps; ++s) {
    __syncthreads();                 // stage s is stored; s-2 is done
    mma_stage(smem + (s % STAGES) * STAGE, d, s % FOLD == 0);
    if ((s + 1) % FOLD == 0 || s + 1 == steps) {
      wgmma_wait<0>();               // fold: every MMA so far is done
      fence_acc(d);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] += d[i];
    } else {
      wgmma_wait<1>();               // step s-1's MMAs are done
    }
    if (s + 1 < steps)
      store_step<TA, TB>(smem + ((s + 1) % STAGES) * STAGE, P, va, vb);
    if (s + 2 < steps) load_step<TA, TB>(P, s0 + s + 2, nk, m0, n0, va, vb);
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rows = P.M + P.has_extra;
  auto store = [&](int r, int c, float x) {
    if (c >= P.N || r >= rows) return;
    if (P.splits > 1)
      P.C[((size_t)split * rows + r) * P.N + c] = x;
    else if (r < P.M)
      P.C[(size_t)r * P.N + c] = EPI ? epilogue(P.bias, P.row_scale, r, c, x)
                                     : x;
    else
      P.C_extra[c] = x;
  };
  const int r = m0 + (warp >> 2) * 64 + (warp & 3) * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c = n0 + j * 8 + 2 * (lane & 3);
    store(r, c, acc[4 * j]);
    store(r, c + 1, acc[4 * j + 1]);
    store(r + 8, c, acc[4 * j + 2]);
    store(r + 8, c + 1, acc[4 * j + 3]);
  }
}

__device__ void reduce(const TcReduce& R, int item) {
  const size_t n = (size_t)(R.M + (R.C_extra != nullptr)) * R.N;
  const size_t mn = (size_t)R.M * R.N;
  const size_t lo = (size_t)item * R.elems;
  const size_t hi = min(n, lo + R.elems);
  for (size_t i = lo + threadIdx.x; i < hi; i += THREADS) {
    float v = R.part[i];
    for (int s = 1; s < R.splits; ++s) v += R.part[s * n + i];
    if (i < mn) {
      if (R.bias != nullptr)
        v = epilogue(R.bias, R.row_scale, (int)(i / R.N), (int)(i % R.N), v);
      R.C[i] = v;
    } else
      R.C_extra[i - mn] = v;
  }
}

}  // namespace tc

template <int LAYOUT>
__global__ void __launch_bounds__(tc::THREADS, 1)
gemm_tc_kernel(const __grid_constant__ TcLaunch L) {
  extern __shared__ __align__(16) unsigned char tc_raw[];
  // the swizzled tiles need 1024-byte alignment
  unsigned char* smem = tc_raw + ((1024 - (tc::smem_addr(tc_raw) & 1023)) &
                                  1023);
  int item = blockIdx.x;
  if (item < L.red.items) {
    tc::reduce(L.red, item);
    return;
  }
  item -= L.red.items;
  int p = 0;
  while (p + 1 < L.count && item >= L.item_end[p]) ++p;
  const TcProb& P = L.p[p];
  item -= p ? L.item_end[p - 1] : 0;
  if (LAYOUT == tc::NN)
    tc::tile<false, false, true>(P, item, smem);
  else if (P.ta)
    tc::tile<true, false, false>(P, item, smem);
  else
    tc::tile<false, true, false>(P, item, smem);
}

// The widest copy (log2 values: at most `max_l`, else 1 or 0) that a
// pointer of `esize`-byte values, its row stride and its contiguous extent
// allow.
static inline int tc_lvec(const void* p, int ld, int extent, int esize,
                          int max_l = 2) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  for (int l = max_l; l > 0; --l) {
    const int v = 1 << l;
    if (a % (esize * v) == 0 && ld % v == 0 && extent % v == 0) return l;
  }
  return 0;
}

// A product for `gemm_tc`: C = op(A)·op(B) with op(A) M x K, op(B) K x N,
// row strides from the stored shapes.
static inline TcProb tc_prob(bool ta, bool tb, const void* A, const void* B,
                             float* C, int M, int N, int K) {
  TcProb p{};
  p.A[0] = A;
  p.B[0] = B;
  p.C = C;
  p.M = M;
  p.N = N;
  p.K = K;
  p.ta = ta;
  p.tb = tb;
  p.lda = ta ? M : K;
  p.ldb = tb ? K : N;
  p.terms = 1;
  p.splits = 1;
  return p;
}

// Reduce items summing `splits` partials of an M x N product (and its extra
// row when C_extra is set), `elems` partial elements an item.
static inline TcReduce tc_reduce(const float* part, float* C, float* C_extra,
                                 int M, int N, int splits, int elems) {
  TcReduce r{};
  r.part = part;
  r.C = C;
  r.C_extra = C_extra;
  r.M = M;
  r.N = N;
  r.splits = splits;
  r.elems = elems;
  r.items = (int)(((size_t)(M + (C_extra != nullptr)) * N + elems - 1) /
                  elems);
  return r;
}

// Launch `L.count` products of one LAYOUT (MIXED: each ta with !tb or !ta
// with tb; NN: neither, with an epilogue) and `L.red`'s reduce items; fills
// in tiles, item ranges and copy widths.
template <int LAYOUT>
static cudaError_t gemm_tc(TcLaunch& L, cudaStream_t s) {
  cudaError_t err =
      allow_smem_once((const void*)gemm_tc_kernel<LAYOUT>, tc::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  if (L.red.items > 0 && L.red.elems < 1) return cudaErrorInvalidValue;
  int items = 0;
  for (int i = 0; i < L.count; ++i) {
    TcProb& p = L.p[i];
    const bool ok = (LAYOUT == tc::NN
                         ? !p.ta && !p.tb && !p.has_extra
                         : p.ta != p.tb && (p.ta || !p.has_extra) &&
                               p.bias == nullptr) &&
                    !(p.a_bf16 && p.extra != nullptr);   // bf16: ones only
    if (!ok) return cudaErrorInvalidValue;
    p.tiles_m = (p.M + p.has_extra + tc::BM - 1) / tc::BM;
    p.tiles_n = (p.N + tc::BN - 1) / tc::BN;
    p.lvec_a = p.lvec_b = 2;
    for (int t = 0; t < p.terms; ++t) {
      if (p.A[t] != nullptr)
        p.lvec_a = min(p.lvec_a, tc_lvec(p.A[t], p.lda, p.ta ? p.M : p.K,
                                         p.a_bf16 ? 2 : 4));
      p.lvec_b = min(p.lvec_b, tc_lvec(p.B[t], p.ldb, p.tb ? p.K : p.N,
                                       p.b_bf16 ? 2 : 4));
    }
    items += p.tiles_m * p.tiles_n * p.splits;
    L.item_end[i] = items;
  }
  gemm_tc_kernel<LAYOUT>
      <<<L.red.items + items, tc::THREADS, tc::SMEM_BYTES, s>>>(L);
  return cudaGetLastError();
}
