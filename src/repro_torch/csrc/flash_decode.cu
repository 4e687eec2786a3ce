// Flash-decode: one query token per sequence against a KV cache, split
// over the cache length into online-softmax partials (m, l, acc), then an
// exact combine in a fixed order. Deterministic, no atomics.
//
// Replaces the Pallas TPU kernel `flash_decode_partials` (_fd_kernel) of
// src/repro/kernels/flash_decode/kernel.py and its `combine_partials`
// (plain jnp there, a second small kernel here). Decode offers no query
// parallelism, so the cache length is split: one CTA per (split, kv head,
// batch) holds all G = H / K query heads of its kv head (GQA without a
// repeat). The combine kernel gives each (batch, head, column) one thread
// that reads the partials in split order.
// Validity is data: k_pos (B, S) int32 (pads at <= -1e8; causal against
// q_pos (B,); an optional window); the decode path folds the window into
// k_pos and passes window = 0. Keys past the cache end get p = 0. Masked
// scores take the finite sentinel -1e30: a split whose keys are all masked
// keeps m = -1e30 and gets weight exp(-1e30 - m_max) = 0 in the combine.
//
// Bound: bytes. At the LM decode shape (B=8, S=1056, K=8, D=80, bf16) the
// cache is 21.6 MB, read once: 6.5 us at 3.35 TB/s; the arithmetic (4·D
// FLOP per (head, key)) is 0.2 GFLOP.
//
// Design for that: every warp works alone on 32-key chunks of its CTA's
// split, one key per lane, with no block-wide barrier until the end. A
// lane loads its key's k row with 16-byte loads straight into registers
// and takes the dot products with all G query heads (q in shared memory,
// read as broadcast 16-byte vectors); the warp's online softmax per head
// is a shuffle max and sum, so m and l are the same in every lane; the
// chunk's v rows are staged with 16-byte loads into the warp's own f32
// buffer, and each lane accumulates P·V for the columns lane + 32t, the
// probabilities broadcast from their key's lane. At the end the four
// warps' (m, l, acc) are merged in warp order into the split's partial.
// The split plan (ops.py) gives every SM about four CTAs of 128 keys.
#include "attn_common.cuh"

constexpr int FD_T = 128;         // keys per CTA round: 4 warps x 32
constexpr int FD_THREADS = 128;
constexpr int FD_WARPS = FD_THREADS / 32;
constexpr int FD_MAX_G = 16;      // query heads per kv head

template <int G, int D>
constexpr size_t fd_smem_bytes() {
  return (size_t)(G * D + FD_WARPS * 32 * D + FD_WARPS * G * (D + 2)) *
         sizeof(float);
}

template <typename T, int G, int D>
__global__ void __launch_bounds__(FD_THREADS)
flash_decode_partials_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v,
                             const int* __restrict__ q_pos,
                             const int* __restrict__ k_pos,
                             float* __restrict__ m_out,
                             float* __restrict__ l_out,
                             float* __restrict__ acc_out, int S,
                             int n_splits, int per_split, long long q_sb,
                             long long q_sh, long long k_sb, long long k_ss,
                             long long k_sh, long long v_sb, long long v_ss,
                             long long v_sh, long long kp_sb,
                             long long qp_sb, float scale, int window) {
  constexpr int V = Row16<T>::n;         // elements per 16-byte load
  constexpr int NC = (D + 31) / 32;      // output columns per lane
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                      // [G][D]
  float* Vw = Qs + G * D;                // [warp][32][D] staged v rows
  float* Wm = Vw + FD_WARPS * 32 * D;    // [warp][G] warp partials
  float* Wl = Wm + FD_WARPS * G;         // [warp][G]
  float* Wa = Wl + FD_WARPS * G;         // [warp][G][D]

  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int K = gridDim.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int s0 = split * per_split, s1 = min(S, s0 + per_split);
  const T* kb = k + b * k_sb + hk * k_sh;
  const T* vb = v + b * v_sb + hk * v_sh;
  const int* kpb = k_pos + b * kp_sb;
  const int qp = q_pos[b * qp_sb];
  float* vw = Vw + warp * 32 * D;

  // the G query heads of this kv head are contiguous in h = hk * G + g
  stage_rows<T, D, D>(Qs, q + b * q_sb + (long long)hk * G * q_sh, q_sh, G,
                      G);
  __syncthreads();

  float m[G], l[G], acc[G][NC];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = ATTN_NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int t = 0; t < NC; ++t) acc[g][t] = 0.f;
  }

  for (int c0 = s0 + 32 * warp; c0 < s1; c0 += FD_T) {
    const int key = c0 + lane;
    const bool in = key < s1;
    const bool keep = in && attn_keep(qp, kpb[in ? key : s0], 1, window);
    // scores of this lane's key against the G heads
    float sc[G];
#pragma unroll
    for (int g = 0; g < G; ++g) sc[g] = 0.f;
    if (keep) {
      const T* kr = kb + key * k_ss;
#pragma unroll 2
      for (int d0 = 0; d0 < D; d0 += V) {
        float kf[V];
        Row16<T>::load(kr + d0, kf);
#pragma unroll
        for (int e = 0; e < V; e += 4) {
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const float4 qv =
                *reinterpret_cast<const float4*>(Qs + g * D + d0 + e);
            sc[g] = fmaf(qv.x, kf[e], sc[g]);
            sc[g] = fmaf(qv.y, kf[e + 1], sc[g]);
            sc[g] = fmaf(qv.z, kf[e + 2], sc[g]);
            sc[g] = fmaf(qv.w, kf[e + 3], sc[g]);
          }
        }
      }
    }
    // stage the chunk's v rows (past the split: zeros)
    for (int f = lane; f < 32 * (D / V); f += 32) {
      const int r = f / (D / V), c = (f % (D / V)) * V;
      float tmp[V];
      if (c0 + r < s1) {
        Row16<T>::load(vb + (c0 + r) * v_ss + c, tmp);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) tmp[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < V; j += 4)
        *reinterpret_cast<float4*>(vw + r * D + c + j) =
            make_float4(tmp[j], tmp[j + 1], tmp[j + 2], tmp[j + 3]);
    }
    // online softmax per head over the warp's 32 keys
    float p[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float s = keep ? sc[g] * scale : ATTN_NEG_INF;
      float mx = fmaxf(m[g], s);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      p[g] = in ? expf(s - mx) : 0.f;
      float ps = p[g];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, o);
      const float corr = expf(m[g] - mx);
      l[g] = l[g] * corr + ps;
#pragma unroll
      for (int t = 0; t < NC; ++t) acc[g][t] *= corr;
      m[g] = mx;
    }
    __syncwarp();                        // v rows staged
    const int nk = min(32, s1 - c0);
    for (int c = 0; c < nk; ++c) {
      float vv[NC];
#pragma unroll
      for (int t = 0; t < NC; ++t)
        vv[t] = (lane + 32 * t < D) ? vw[c * D + lane + 32 * t] : 0.f;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float pc = __shfl_sync(0xffffffffu, p[g], c);
#pragma unroll
        for (int t = 0; t < NC; ++t) acc[g][t] = fmaf(pc, vv[t], acc[g][t]);
      }
    }
    __syncwarp();                        // v rows consumed
  }

  // merge the warps' partials in warp order; an empty split writes
  // m = -1e30, l = 0, acc = 0
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      Wm[warp * G + g] = m[g];
      Wl[warp * G + g] = l[g];
    }
#pragma unroll
    for (int t = 0; t < NC; ++t)
      if (lane + 32 * t < D) Wa[(warp * G + g) * D + lane + 32 * t] =
          acc[g][t];
  }
  __syncthreads();
  const long long row0 = ((long long)b * K + hk) * G;
  for (int o = tid; o < G * (D + 1); o += FD_THREADS) {
    const int g = o / (D + 1), d = o % (D + 1);   // d == D: m and l
    float m_cta = Wm[g];
#pragma unroll
    for (int w = 1; w < FD_WARPS; ++w) m_cta = fmaxf(m_cta, Wm[w * G + g]);
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < FD_WARPS; ++w) {
      const float wt = expf(Wm[w * G + g] - m_cta);
      a += (d < D ? Wa[(w * G + g) * D + d] : Wl[w * G + g]) * wt;
    }
    if (d < D) {
      acc_out[((row0 + g) * n_splits + split) * D + d] = a;
    } else {
      m_out[(row0 + g) * n_splits + split] = m_cta;
      l_out[(row0 + g) * n_splits + split] = a;
    }
  }
}

// out[row, d] = sum_s acc[row, s, d] w_s / max(sum_s l[row, s] w_s, 1e-30)
// with w_s = exp(m[row, s] - max_s m[row, s]), splits taken in order.
template <typename T>
__global__ void flash_decode_combine_kernel(const float* __restrict__ m,
                                            const float* __restrict__ l,
                                            const float* __restrict__ acc,
                                            T* __restrict__ out, int rows,
                                            int n_splits, int D) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)rows * D) return;
  const long long row = i / D;
  const int d = (int)(i % D);
  const float* mr = m + row * n_splits;
  const float* lr = l + row * n_splits;
  float m_max = mr[0];
  for (int s = 1; s < n_splits; ++s) m_max = fmaxf(m_max, mr[s]);
  float l_tot = 0.f, a_tot = 0.f;
  for (int s = 0; s < n_splits; ++s) {
    const float w = expf(mr[s] - m_max);
    l_tot += lr[s] * w;
    a_tot += acc[(row * n_splits + s) * D + d] * w;
  }
  out[i] = from_f32<T>(a_tot / fmaxf(l_tot, 1e-30f));
}

template <typename T, int G, int D>
static int launch(const void* q, const void* k, const void* v,
                  const int* q_pos, const int* k_pos, float* m, float* l,
                  float* acc, void* out, int B, int S, int H, int K,
                  int n_splits, int per_split, const long long* st,
                  float scale, int window, cudaStream_t stream) {
  const size_t smem = fd_smem_bytes<G, D>();
  cudaError_t err = allow_smem(flash_decode_partials_kernel<T, G, D>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(n_splits, K, B);
  flash_decode_partials_kernel<T, G, D><<<grid, FD_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), q_pos, k_pos, m, l, acc, S, n_splits,
      per_split, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], st[9], scale, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long n = (long long)B * H * D;
  flash_decode_combine_kernel<T><<<(unsigned)((n + 127) / 128), 128, 0,
                                   stream>>>(m, l, acc, static_cast<T*>(out),
                                             B * H, n_splits, D);
  return (int)cudaGetLastError();
}

template <typename T, int G>
static int dispatch_d(int D, const void* q, const void* k, const void* v,
                      const int* q_pos, const int* k_pos, float* m, float* l,
                      float* acc, void* out, int B, int S, int H, int K,
                      int n_splits, int per_split, const long long* st,
                      float scale, int window, cudaStream_t s) {
#define FD_CASE(DD)                                                         \
  case DD:                                                                  \
    return launch<T, G, DD>(q, k, v, q_pos, k_pos, m, l, acc, out, B, S, H, \
                            K, n_splits, per_split, st, scale, window, s);
  switch (D) {
    FD_CASE(16)
    FD_CASE(32)
    FD_CASE(64)
    FD_CASE(80)
    FD_CASE(96)
    FD_CASE(128)
  }
#undef FD_CASE
  return (int)cudaErrorInvalidValue;
}

template <typename T>
static int dispatch(int D, const void* q, const void* k, const void* v,
                    const int* q_pos, const int* k_pos, float* m, float* l,
                    float* acc, void* out, int B, int S, int H, int K,
                    int n_splits, int per_split, const long long* st,
                    float scale, int window, cudaStream_t s) {
#define FD_G(GG)                                                          \
  case GG:                                                                \
    return dispatch_d<T, GG>(D, q, k, v, q_pos, k_pos, m, l, acc, out, B, \
                             S, H, K, n_splits, per_split, st, scale,     \
                             window, s);
  switch (H / K) {
    FD_G(1)
    FD_G(2)
    FD_G(4)
    FD_G(8)
    FD_G(16)
  }
#undef FD_G
  return (int)cudaErrorInvalidValue;
}

// q (B,1,H,D) with strides (q_sb, ., q_sh, 1); k/v (B,S,K,D) with strides
// (sb, ss, sh, 1); k_pos (B,S) int32 with batch stride kp_sb (0 when
// shared) and unit position stride; q_pos (B,) with stride qp_sb; m, l
// (B,K,G,n_splits) and acc (B,K,G,n_splits,D) f32 scratch; out (B,1,H,D)
// contiguous; G = H / K in {1, 2, 4, 8, 16}; dtype 0 = f32, 1 = bf16.
extern "C" int flash_decode_launch(
    const void* q, const void* k, const void* v, const int* q_pos,
    const int* k_pos, float* m, float* l, float* acc, void* out, int B,
    int S, int H, int K, int D, int n_splits, int per_split, long long q_sb,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long kp_sb,
    long long qp_sb, float scale, int window, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K < 1 || H % K != 0 || H / K > FD_MAX_G || n_splits < 1 ||
      per_split < 1)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  const long long st[10] = {q_sb, q_sh, k_sb, k_ss, k_sh,
                            v_sb, v_ss, v_sh, kp_sb, qp_sb};
  if (dtype == 0)
    return dispatch<float>(D, q, k, v, q_pos, k_pos, m, l, acc, out, B, S,
                           H, K, n_splits, per_split, st, scale, window, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(D, q, k, v, q_pos, k_pos, m, l, acc, out,
                                   B, S, H, K, n_splits, per_split, st, scale,
                                   window, s);
  return (int)cudaErrorInvalidValue;
}
