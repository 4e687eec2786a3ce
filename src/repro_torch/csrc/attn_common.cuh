// Shared by the attention kernels (flash_attention.cu, flash_decode.cu):
// the finite mask sentinel, the pad-key limit, the 16-byte row loads that
// stage (position, head) rows of D values into f32 shared memory, and the
// shared-memory address and cp.async helpers.
#pragma once

#include "common.cuh"

// Masked scores take this finite value, as the TPU kernels do: a tile (or
// split) in which every key is masked keeps m = ATTN_NEG_INF and gets
// p = exp(0) = 1, which the next live tile's correction exp(m_prev - m_cur)
// (or the combine's weight) then multiplies by exactly 0. -inf would give
// inf - inf = NaN there.
constexpr float ATTN_NEG_INF = -1e30f;
constexpr int ATTN_PAD_LIMIT = -100000000;   // k_pos <= -1e8: a pad key

// 16 bytes of T widened to f32: 4 floats or 8 bf16 values.
template <typename T> struct Row16;
template <> struct Row16<float> {
  static constexpr int n = 4;
  __device__ static void load(const float* src, float* dst) {
    const float4 x = *reinterpret_cast<const float4*>(src);
    dst[0] = x.x; dst[1] = x.y; dst[2] = x.z; dst[3] = x.w;
  }
};
template <> struct Row16<__nv_bfloat16> {
  static constexpr int n = 8;
  __device__ static void load(const __nv_bfloat16* src, float* dst) {
    const uint4 x = *reinterpret_cast<const uint4*>(src);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      dst[2 * i] = f.x;
      dst[2 * i + 1] = f.y;
    }
  }
};

// Stage `rows` rows of D values (row r at base + r * stride) into dst with
// leading dimension LD, widened to f32; rows at or past `valid` are zeros.
// With LD a multiple of 4 the shared stores are 16-byte vectors. The whole
// block takes part; the caller synchronises.
template <typename T, int D, int LD>
__device__ __forceinline__ void stage_rows(float* dst, const T* base,
                                           long long stride, int rows,
                                           int valid) {
  constexpr int V = Row16<T>::n;
  static_assert(D % V == 0, "head dim must be a multiple of 16 bytes");
  constexpr int VPR = D / V;
  for (int i = threadIdx.x; i < rows * VPR; i += blockDim.x) {
    const int r = i / VPR, c = (i % VPR) * V;
    float tmp[V];
    if (r < valid) {
      Row16<T>::load(base + (long long)r * stride + c, tmp);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) tmp[j] = 0.f;
    }
    if constexpr (LD % 4 == 0) {
#pragma unroll
      for (int j = 0; j < V; j += 4)
        *reinterpret_cast<float4*>(dst + r * LD + c + j) =
            make_float4(tmp[j], tmp[j + 1], tmp[j + 2], tmp[j + 3]);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) dst[r * LD + c + j] = tmp[j];
    }
  }
}

// Stage ROWS rows of D values transposed: dst[d * ROWS + r] (d-major), so
// a thread reads four neighbouring rows at one d as one 16-byte vector.
// Lanes take neighbouring rows of one 16-byte column chunk, so the
// scattered shared stores of a warp fall on 32 distinct banks.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void stage_rows_t(float* dst, const T* base,
                                             long long stride, int valid) {
  constexpr int V = Row16<T>::n;
  static_assert(D % V == 0, "head dim must be a multiple of 16 bytes");
  for (int i = threadIdx.x; i < ROWS * (D / V); i += blockDim.x) {
    const int r = i % ROWS, c = (i / ROWS) * V;
    float tmp[V];
    if (r < valid) {
      Row16<T>::load(base + (long long)r * stride + c, tmp);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) tmp[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < V; ++j) dst[(c + j) * ROWS + r] = tmp[j];
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; zero-filled when !valid (the
// source is then not read, but must still be a valid address)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The mask of one (query, key) pair, as the TPU kernels apply it.
__device__ __forceinline__ bool attn_keep(int qp, int kp, int causal,
                                          int window) {
  const int dpos = qp - kp;
  return kp > ATTN_PAD_LIMIT && (!causal || dpos >= 0) &&
         (window <= 0 || dpos < window);
}
