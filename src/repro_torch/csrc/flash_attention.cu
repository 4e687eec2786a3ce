// Causal / sliding-window GQA flash attention over explicit positions
// (prefill), online softmax in f32, deterministic.
//
// Replaces the Pallas TPU kernel `flash_attention_bhsd` (_fa_kernel) of
// src/repro/kernels/flash_attention/kernel.py. The TPU kernel walks the kv
// blocks on a sequential grid axis and carries (m, l, acc) in VMEM scratch
// from one grid step to the next; Hopper blocks run in no order, so here
// one CTA owns a (batch, head, 128-query tile) and loops over the 64-key
// tiles itself. q/k/v are read in the port's (B, S, heads, D) layout by
// strides (no transposes); the kv head is h / G (GQA without a repeat).
// Positions are data: q_pos (Sq,) and k_pos (Sk,) int32; keys at
// k_pos <= -1e8 are pads, causal keeps q_pos - k_pos >= 0, a window keeps
// q_pos - k_pos < window. The ragged edge (S not a multiple of 64) is
// masked inside the kernel: keys past Sk get p = 0, rows past Sq are not
// stored. Masked scores take the finite sentinel -1e30 (attn_common.cuh).
//
// Bound: at the LM prefill shape (B=8, S=1024, H=32, K=8, D=80, causal,
// bf16) the work is 4·D FLOP per unmasked (q, k) pair, 4.3e10 FLOP: 43 us
// at the bf16 tensor-core rate (989 TFLOP/s), 0.64 ms at the fp32 FFMA rate
// (67 TFLOP/s), against 21 MB of q/k/v/out (6 us at 3.35 TB/s): operations.
// This first kernel computes in f32 FFMA (scores and P·V in f32, no TF32,
// as the reference does), so its own floor is the fp32 one.
//
// Design: 256 threads; thread (ty, tx) = (tid / 8, tid % 8) owns query
// rows 4ty + i (i < 4) and, per tile, keys 4tx + j and 32 + 4tx + j
// (j < 4) of the score tile and output columns 16m + 2tx + e (e < 2). The
// q tile and each k tile are staged in shared memory as f32 and
// transposed (d-major), so at each d a thread reads its four rows as one
// 16-byte vector and its eight keys as two. p goes through shared memory
// key-major (rows padded to 132 floats) in the k tile's space, dead by
// then, and the v tile row-major, so the P·V product reads four
// probabilities and two values a vector at a time. Each k/v tile serves
// 128 query rows; 95 KB of shared memory and at most 128 registers a
// thread at D = 80 leave room for two CTAs (16 warps) on an SM. Every shared read of a
// warp is one conflict-free wavefront, and the FMAs outnumber the shared
// loads about 11 to 1. A row's max is a shuffle over its 8 lanes; its l is
// kept per thread and summed once at the end.
//
// A k tile in which no (q, k) pair is kept is skipped before its k and v
// rows are loaded, but only once every row of the q tile has seen a kept
// key: then m is finite, p = exp(-1e30 - m) is exactly 0 and the
// correction exactly 1, so skipping changes no bit (before that, a dead
// tile adds p = 1 terms that the first live tile's correction wipes, and
// it is computed as the reference computes it). The skip is decided from
// the tile's actual positions, so rolling (non-monotone) k_pos is safe.
// No atomics: every sum has one owner and a fixed order.
#include "attn_common.cuh"

constexpr int FA_Q = 128;         // query rows per CTA
constexpr int FA_T = 64;          // keys per tile
constexpr int FA_THREADS = 256;
constexpr int FA_PLD = FA_Q + 4;  // p tile: key-major, rows of 132 floats

// The k tile is dead once the scores are taken, so p reuses its space:
// 95 KB at D = 80, two CTAs (16 warps) to an SM.
template <int D>
__host__ __device__ constexpr int fa_kp_floats() {
  return FA_T * (D > FA_PLD ? D : FA_PLD);
}

template <int D>
constexpr size_t fa_smem_bytes() {
  return (size_t)((FA_Q + FA_T) * D + fa_kp_floats<D>()) * sizeof(float) +
         (FA_Q + FA_T) * sizeof(int);
}

// the key of score slot j (< 8) of lane tx: 4tx + j and 32 + 4tx + j - 4
__device__ __forceinline__ int fa_key(int tx, int j) {
  return 4 * tx + (j & 3) + 32 * (j >> 2);
}

template <typename T, int D>
__global__ void __launch_bounds__(FA_THREADS, 2)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v,
                       const int* __restrict__ q_pos,
                       const int* __restrict__ k_pos, T* __restrict__ out,
                       int Sq, int Sk, int H, int G, long long q_sb,
                       long long q_ss, long long q_sh, long long k_sb,
                       long long k_ss, long long k_sh, long long v_sb,
                       long long v_ss, long long v_sh, float scale,
                       int causal, int window) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int DM = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;                      // [D][128] d-major
  float* Vs = Qt + FA_Q * D;             // [64][D]  key-major
  float* Kt = Vs + FA_T * D;             // [D][64]  d-major, then
  float* Pt = Kt;                        // [64][132] key-major p
  int* qp_s = reinterpret_cast<int*>(Kt + fa_kp_floats<D>());
  int* kp_s = qp_s + FA_Q;

  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;
  const int q0 = blockIdx.x * FA_Q, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / G;
  const int nq = min(FA_Q, Sq - q0);
  const T* kb = k + b * k_sb + hk * k_sh;
  const T* vb = v + b * v_sb + hk * v_sh;

  stage_rows_t<T, D, FA_Q>(Qt, q + b * q_sb + h * q_sh + q0 * q_ss, q_ss,
                           nq);
  for (int i = tid; i < FA_Q; i += FA_THREADS)
    qp_s[i] = i < nq ? q_pos[q0 + i] : 0;

  float m[4], l[4], acc[4][DM][2];
  bool row_in[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = ATTN_NEG_INF;
    l[i] = 0.f;
    row_in[i] = 4 * ty + i < nq;
#pragma unroll
    for (int j = 0; j < DM; ++j) acc[i][j][0] = acc[i][j][1] = 0.f;
  }

  for (int k0 = 0; k0 < Sk; k0 += FA_T) {
    const int nk = min(FA_T, Sk - k0);
    __syncthreads();                     // previous tile consumed
    for (int i = tid; i < FA_T; i += FA_THREADS)
      kp_s[i] = i < nk ? k_pos[k0 + i] : 0;
    __syncthreads();

    // this thread's 4 x 8 pairs: kept, and is any kept / every row live
    bool keep[4][8];
    int any_kept = 0, rows_live = 1;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = qp_s[4 * ty + i];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = fa_key(tx, j);
        keep[i][j] = c < nk && attn_keep(qp, kp_s[c], causal, window);
        any_kept |= (row_in[i] && keep[i][j]);
      }
      rows_live &= (!row_in[i] || m[i] > 0.5f * ATTN_NEG_INF);
    }
    const int tile_kept = __syncthreads_or(any_kept);
    if (!tile_kept && __syncthreads_and(rows_live)) continue;

    stage_rows_t<T, D, FA_T>(Kt, kb + k0 * k_ss, k_ss, nk);
    stage_rows<T, D, D>(Vs, vb + k0 * v_ss, v_ss, FA_T, nk);
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(Qt + d * FA_Q +
                                                         4 * ty);
      const float4 ka = *reinterpret_cast<const float4*>(Kt + d * FA_T +
                                                         4 * tx);
      const float4 kc = *reinterpret_cast<const float4*>(Kt + d * FA_T +
                                                         32 + 4 * tx);
      const float qr[4] = {qv.x, qv.y, qv.z, qv.w};
      const float kr[8] = {ka.x, ka.y, ka.z, ka.w, kc.x, kc.y, kc.z, kc.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qr[i], kr[j], s[i][j]);
    }

    float p[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = keep[i][j] ? s[i][j] * scale : ATTN_NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float corr = expf(m[i] - mx);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        p[i][j] = fa_key(tx, j) < nk ? expf(s[i][j] - mx) : 0.f;
        ps += p[i][j];
      }
      l[i] = l[i] * corr + ps;
#pragma unroll
      for (int j = 0; j < DM; ++j) {
        acc[i][j][0] *= corr;
        acc[i][j][1] *= corr;
      }
      m[i] = mx;
    }
    __syncthreads();                     // every k read: p may overwrite
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<float4*>(Pt + fa_key(tx, j) * FA_PLD + 4 * ty) =
          make_float4(p[0][j], p[1][j], p[2][j], p[3][j]);
    __syncthreads();                     // p and the v tile are in place

    for (int c = 0; c < nk; ++c) {
      const float4 pv = *reinterpret_cast<const float4*>(Pt + c * FA_PLD +
                                                         4 * ty);
      const float pr[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
      for (int j = 0; j < DM; ++j) {
        const float2 vv = *reinterpret_cast<const float2*>(
            Vs + c * D + 16 * j + 2 * tx);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][j][0] = fmaf(pr[i], vv.x, acc[i][j][0]);
          acc[i][j][1] = fmaf(pr[i], vv.y, acc[i][j][1]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float lt = l[i];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    lt += __shfl_xor_sync(0xffffffffu, lt, 4);
    if (!row_in[i]) continue;
    const float inv = 1.f / fmaxf(lt, 1e-30f);
    T* o = out + (((long long)b * Sq + q0 + 4 * ty + i) * H + h) * D;
#pragma unroll
    for (int j = 0; j < DM; ++j) {
      o[16 * j + 2 * tx] = from_f32<T>(acc[i][j][0] * inv);
      o[16 * j + 2 * tx + 1] = from_f32<T>(acc[i][j][1] * inv);
    }
  }
}

template <typename T, int D>
static int launch(const void* q, const void* k, const void* v,
                  const int* q_pos, const int* k_pos, void* out, int B,
                  int Sq, int Sk, int H, int K, const long long* st,
                  float scale, int causal, int window, cudaStream_t stream) {
  const size_t smem = fa_smem_bytes<D>();
  cudaError_t err = allow_smem(flash_attention_kernel<T, D>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + FA_Q - 1) / FA_Q, H, B);
  flash_attention_kernel<T, D><<<grid, FA_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), q_pos, k_pos, static_cast<T*>(out), Sq, Sk,
      H, H / K, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], scale, causal, window);
  return (int)cudaGetLastError();
}

template <typename T>
static int dispatch(int D, const void* q, const void* k, const void* v,
                    const int* q_pos, const int* k_pos, void* out, int B,
                    int Sq, int Sk, int H, int K, const long long* st,
                    float scale, int causal, int window, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, q_pos, k_pos, out, B, Sq, Sk, H,
                                  K, st, scale, causal, window, s);
    case 32: return launch<T, 32>(q, k, v, q_pos, k_pos, out, B, Sq, Sk, H,
                                  K, st, scale, causal, window, s);
    case 64: return launch<T, 64>(q, k, v, q_pos, k_pos, out, B, Sq, Sk, H,
                                  K, st, scale, causal, window, s);
    case 80: return launch<T, 80>(q, k, v, q_pos, k_pos, out, B, Sq, Sk, H,
                                  K, st, scale, causal, window, s);
    case 96: return launch<T, 96>(q, k, v, q_pos, k_pos, out, B, Sq, Sk, H,
                                  K, st, scale, causal, window, s);
    case 128: return launch<T, 128>(q, k, v, q_pos, k_pos, out, B, Sq, Sk,
                                    H, K, st, scale, causal, window, s);
  }
  return (int)cudaErrorInvalidValue;
}

// q (B,Sq,H,D), k/v (B,Sk,K,D) with unit stride along D and the given
// (batch, position, head) strides in elements; out (B,Sq,H,D) contiguous;
// q_pos (Sq,), k_pos (Sk,) int32; dtype 0 = f32, 1 = bf16.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, const int* q_pos,
    const int* k_pos, void* out, int B, int Sq, int Sk, int H, int K, int D,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, float scale, int causal, int window, int dtype,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K < 1 || H % K != 0) return (int)cudaErrorInvalidValue;
  if (Sq == 0 || B == 0) return (int)cudaSuccess;
  const long long st[9] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                           v_sb, v_ss, v_sh};
  if (dtype == 0)
    return dispatch<float>(D, q, k, v, q_pos, k_pos, out, B, Sq, Sk, H, K,
                           st, scale, causal, window, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(D, q, k, v, q_pos, k_pos, out, B, Sq, Sk,
                                   H, K, st, scale, causal, window, s);
  return (int)cudaErrorInvalidValue;
}
