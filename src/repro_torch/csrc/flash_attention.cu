// Causal / sliding-window GQA flash attention over explicit positions
// (prefill), online softmax in f32, deterministic.
//
// Replaces the Pallas TPU kernel `flash_attention_bhsd` (_fa_kernel) of
// src/repro/kernels/flash_attention/kernel.py. The TPU kernel walks the kv
// blocks on a sequential grid axis and carries (m, l, acc) in VMEM scratch
// from one grid step to the next; Hopper blocks run in no order, so here
// one CTA owns a (batch, head, query tile) and loops over the 64-key tiles
// itself. q/k/v are read in the port's (B, S, heads, D) layout by strides
// (no transposes); the kv head is h / G (GQA without a repeat). Positions
// are data: q_pos (Sq,) and k_pos (Sk,) int32; keys at k_pos <= -1e8 are
// pads, causal keeps q_pos - k_pos >= 0, a window keeps q_pos - k_pos <
// window. The ragged edge (S not a multiple of 64) is masked inside the
// kernel: keys past Sk get p = 0, rows past Sq are not stored. Masked
// scores take the finite sentinel -1e30 (attn_common.cuh).
//
// Bound: at the LM prefill shape (B=8, S=1024, H=32, K=8, D=80, causal,
// bf16) the work is 4·D FLOP per kept (q, k) pair, 4.3e10 FLOP: 43 us at
// the bf16 tensor-core rate (989 TFLOP/s), 0.64 ms at the fp32 FFMA rate
// (67 TFLOP/s), against 21 MB of q/k/v/out (6 us at 3.35 TB/s):
// operations. Each dtype has one kernel:
//
// bfloat16 (the LM path): flash_attention_bf16_kernel, on the tensor cores.
// A CTA of 4 warps owns 64 query rows, 16 a warp, and keeps its q
// fragments in registers (ldmatrix) for the whole key loop; the CTAs of
// the last query tiles, the longest under a causal mask, start first. k/v tiles of
// 64 keys stream through a two-stage shared-memory ring filled by
// cp.async.cg 16-byte copies: tile n+1 is in flight while tile n computes.
// Rows are padded to D + 8 bf16, so the eight 16-byte rows an ldmatrix
// phase reads fall on distinct banks at every head dim; keys past Sk are
// zero-filled (src-size 0). QKᵀ is mma.sync m16n8k16 (bf16 in, f32
// accumulate: the products of bf16 values are exact in f32), scaled after
// accumulation. Mask and online softmax run on the accumulator fragments:
// a row's max over its quad by two shuffles, exponentials as 2^x of
// log2(e)-scaled scores on the SFU, l from the f32 p. A thread's keep bits
// for a tile come from the tile's range of key positions (two loads a lane
// and a warp reduction), and pair by pair only where that range does not
// decide a row (the diagonal, a window's edge). P·V reuses the score
// registers as A fragments (the m16n8 C layout is the m16k16 A layout),
// so p never goes through shared memory, and v's B fragments come from
// ldmatrix.trans. Above D = 128 the q fragments are read from shared
// memory at each slice instead of held in registers; at D = 192 and 256 a
// CTA's 128 / 133 KB of tiles take an SM. P·V keeps the f32 contract of
// the plain version by splitting p: hi = bf16(p), lo = bf16(p - hi), two
// MMAs into one f32 accumulator. hi + lo holds p to about 2^-17 of
// itself, and the products with bf16 v are exact, so the output is within
// the f32 tolerance of the plain version before its one rounding to
// bf16. One bf16 p (what FlashAttention-2 does) is off by up to 2^-9 of
// each p, and that is not:
// tests/test_torch_flash.py emulates both, and one bf16 p misses the f32
// tolerance (2e-5 x max(1, |ref|)) some 40-55 times over at its shapes,
// where the split stays under a tenth of it. The split costs 6·D instead
// of 4·D tensor-core FLOP per pair, still far below the FFMA floor.
//
// Head dim 256 (gemma3-12b): a CTA's output accumulator would take 128
// f32 registers a thread in the bf16 kernel (16 rows x 256 columns a warp)
// beside the 32 of the score tile and the p fragments, and the f32
// kernel's q, k and v tiles 257 KB of shared memory. So at D = 256 both
// kernels split the output columns: a CTA computes QKᵀ over the whole head
// dim, the softmax on it, and P·V for DV = D / 2 = 128 of the output
// columns only, reading only those columns of v; the grid holds both
// halves of a (batch, head, query tile), neighbours in its fastest
// dimension, so the second reads its k tiles from L2. QKᵀ is computed twice
// (the bf16 kernel's tensor-core work per pair 8·D instead of 6·D); each
// half's accumulators are D = 128's (64 f32 registers a thread in bf16),
// and the f32 kernel's tiles fit one CTA an SM (225 KB). The split changes
// no bit: the scores, the masks and the softmax of both halves are the
// same sums in the same order, and each output column is its own sum. At
// D = 160 (stablelm-12b) neither limit bites and a CTA computes every
// column, as at the other head dims.
//
// float32: flash_attention_f32_kernel, f32 FFMA (no TF32, as the plain
// version computes), so its floor is the fp32 one. 256 threads; thread
// (ty, tx) = (tid / 8, tid % 8) owns query rows 4ty + i (i < 4) and, per
// tile, keys 4tx + j and 32 + 4tx + j (j < 4) of the score tile and output
// columns 16m + 2tx + e (e < 2). The q tile and each k tile are staged in
// shared memory as f32 and transposed (d-major), so at each d a thread
// reads its four rows as one 16-byte vector and its eight keys as two. p
// goes through shared memory key-major (rows padded to 132 floats) in the
// k tile's space, dead by then, and the v tile row-major. Each k/v tile
// serves 128 query rows; 95 KB of shared memory and at most 128 registers
// a thread at D = 80 leave room for two CTAs (16 warps) on an SM; at D =
// 192 (the MLA prefill's q/k head dim) a CTA takes 193 KB and an SM.
//
// Both skip a k tile in which no (q, k) pair is kept before its k and v
// rows are loaded, but only once every row of the q tile has seen a kept
// key: then m is finite, p = exp(-1e30 - m) is exactly 0 and the
// correction exactly 1, so skipping changes no bit (before that, a dead
// tile adds p = 1 terms that the first live tile's correction wipes, and
// it is computed as the plain version computes it). The skip is decided
// from the tile's actual positions, so rolling (non-monotone) k_pos is
// safe. The bf16 kernel decides a tile's fate before it issues the tile's
// copy, one tile ahead: a row counts as live if its max is finite or if it
// keeps a key in the tile being computed. Where that is conservative (a
// dead tile computed once every row is live), the tile adds exact zeros.
// No atomics: every sum has one owner and a fixed order.
#include <climits>

#include "attn_common.cuh"

// ---------------------------------------------------------------------------
// float32: FFMA kernel
// ---------------------------------------------------------------------------

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

// Output columns a CTA computes: half the head dim at D = 256 (see the
// head of this file), all of them below.
template <int D>
__host__ __device__ constexpr int fa_out_cols() {
  return D > 192 ? D / 2 : D;
}

// q tile [128][D], v tile [64][DV], k / p tile, positions
template <int D>
__host__ __device__ constexpr size_t fa_smem_bytes() {
  return (size_t)(FA_Q * D + FA_T * fa_out_cols<D>() + fa_kp_floats<D>()) *
             sizeof(float) +
         (FA_Q + FA_T) * sizeof(int);
}

// CTAs an SM the registers are sized for: two up to D = 128 (at most 128
// registers a thread), one above: at D = 160 and 192 the 161 / 193 KB of
// shared memory leave room for no second CTA and the D/16 x 8
// accumulators need the registers; at D = 256 the 225 KB of a column
// half.
template <int D>
__host__ __device__ constexpr int fa_ctas_per_sm() {
  return D <= 128 ? 2 : 1;
}

// the key of score slot j (< 8) of lane tx: 4tx + j and 32 + 4tx + j - 4
__device__ __forceinline__ int fa_key(int tx, int j) {
  return 4 * tx + (j & 3) + 32 * (j >> 2);
}

template <int D>
__global__ void __launch_bounds__(FA_THREADS, fa_ctas_per_sm<D>())
flash_attention_f32_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const int* __restrict__ q_pos,
                           const int* __restrict__ k_pos,
                           float* __restrict__ out, int Sq, int Sk, int H,
                           int G, long long q_sb, long long q_ss,
                           long long q_sh, long long k_sb, long long k_ss,
                           long long k_sh, long long v_sb, long long v_ss,
                           long long v_sh, float scale, int causal,
                           int window) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int DV = fa_out_cols<D>();   // output columns of this CTA
  constexpr int DM = DV / 16;
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;                      // [D][128] d-major
  float* Vs = Qt + FA_Q * D;             // [64][DV] key-major
  float* Kt = Vs + FA_T * DV;            // [D][64]  d-major, then
  float* Pt = Kt;                        // [64][132] key-major p
  int* qp_s = reinterpret_cast<int*>(Kt + fa_kp_floats<D>());
  int* kp_s = qp_s + FA_Q;

  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;
  // blockIdx.y: the head, then which DV columns of it
  const int q0 = blockIdx.x * FA_Q, h = blockIdx.y / (D / DV),
            c0 = blockIdx.y % (D / DV) * DV, b = blockIdx.z;
  const int hk = h / G;
  const int nq = min(FA_Q, Sq - q0);
  const float* kb = k + b * k_sb + hk * k_sh;
  const float* vb = v + b * v_sb + hk * v_sh + c0;

  stage_rows_t<float, D, FA_Q>(Qt, q + b * q_sb + h * q_sh + q0 * q_ss, q_ss,
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

    stage_rows_t<float, D, FA_T>(Kt, kb + k0 * k_ss, k_ss, nk);
    stage_rows<float, DV, DV>(Vs, vb + k0 * v_ss, v_ss, FA_T, nk);
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
            Vs + c * DV + 16 * j + 2 * tx);
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
    float* o =
        out + (((long long)b * Sq + q0 + 4 * ty + i) * H + h) * D + c0;
#pragma unroll
    for (int j = 0; j < DM; ++j) {
      o[16 * j + 2 * tx] = acc[i][j][0] * inv;
      o[16 * j + 2 * tx + 1] = acc[i][j][1] * inv;
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16: tensor-core kernel
// ---------------------------------------------------------------------------

constexpr int TC_WARPS = 4;
constexpr int TC_Q = 16 * TC_WARPS;   // query rows per CTA, 16 a warp
constexpr int TC_T = 64;              // keys per tile
constexpr int TC_THREADS = 32 * TC_WARPS;
constexpr int TC_STAGES = 2;          // k/v ring depth (stage ^ 1 below)

// q tile + TC_STAGES x (k tile + v tile), rows of D + 8 bf16 (the v
// tile's of DV + 8, the columns this CTA computes): 105 KB at D = 160
// (two CTAs an SM), 128 KB at D = 192 and 133 KB at D = 256 (one)
template <int D>
constexpr size_t tc_smem_bytes() {
  return ((size_t)(TC_Q + TC_STAGES * TC_T) * (D + 8) +
          (size_t)TC_STAGES * TC_T * (fa_out_cols<D>() + 8)) *
         sizeof(__nv_bfloat16);
}

// four 8x8 b16 matrices; lane l gives the row address of matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c (16x8 f32) += a (16x16 bf16, row) · b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the SFU; a result below 2^-126 flushes to 0, 2^-inf is 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}

// p (x, y), neighbouring keys, -> hi = bf16(p) and lo = bf16(p - hi), each
// packed as a bf16 pair (the lower key in the low half). p - hi is exact in
// f32, so hi + lo is p to about 2^-17 of itself.
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = bf16x2_bits(h);
  lo = bf16x2_bits(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

// The keep bits of one thread in tile `tile`: bit 16r + 2n + e is the pair
// (its row r, key 8n + 2t + e of the tile); keys past Sk count as pads. Lane l reads the positions of keys l and l + 32;
// the warp reduces them to the tile's range of real (non-pad) positions,
// and a row whose pairs that range decides (all kept: no pad, the range
// inside the row's causal window; none kept) gets its bits at once. Only a
// warp with a row the range leaves open gathers its keys' positions by
// shuffles and applies attn_keep pair by pair (the diagonal and the
// window's edge). Returns whether a row of this thread that lies inside Sq
// keeps a key.
__device__ __forceinline__ bool tc_tile_keep(int tile, int lane, int t,
                                             int Sk,
                                             const int* __restrict__ k_pos,
                                             const int (&qp)[2],
                                             const bool (&row_in)[2],
                                             int causal, int window,
                                             uint32_t& keep) {
  const int k0 = tile * TC_T, nk = min(TC_T, Sk - k0);
  const int ka = lane < nk ? __ldg(k_pos + k0 + lane) : ATTN_PAD_LIMIT;
  const int kb =
      lane + 32 < nk ? __ldg(k_pos + k0 + lane + 32) : ATTN_PAD_LIMIT;
  const bool pa = ka <= ATTN_PAD_LIMIT, pb = kb <= ATTN_PAD_LIMIT;
  const bool pads = __any_sync(0xffffffffu, pa || pb);
  int lo = min(pa ? INT_MAX : ka, pb ? INT_MAX : kb);
  int hi = max(pa ? INT_MIN : ka, pb ? INT_MIN : kb);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  const bool real = lo <= hi;              // a non-pad key in the tile
  if (!real) lo = hi = 0;
  uint32_t bits[2];
  bool open[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int q = qp[r];
    const bool all = !pads && (!causal || q >= hi) &&
                     (window <= 0 || q - lo < window);
    const bool none = !real || (causal && q < lo) ||
                      (window > 0 && q - hi >= window);
    bits[r] = all ? 0xffffu : 0u;
    open[r] = !all && !none;
  }
  if (__any_sync(0xffffffffu, open[0] || open[1])) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {   // key 8(i / 2) + 2t + i % 2
      const int key = 8 * (i >> 1) + 2 * t + (i & 1);
      const int kp = __shfl_sync(0xffffffffu, i < 8 ? ka : kb, key & 31);
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (open[r])
          bits[r] |= (uint32_t)attn_keep(qp[r], kp, causal, window) << i;
    }
  }
  keep = bits[0] | (bits[1] << 16);
  return (row_in[0] && bits[0]) || (row_in[1] && bits[1]);
}

// The next tile after `c` that the CTA computes (ntiles if none), and this
// thread's keep bits for it. A tile is skipped only if no row of the CTA
// keeps a key in it and every row of the CTA (inside Sq) is live: `live`
// is this thread's rows' state. One barrier per candidate.
__device__ __forceinline__ int tc_next_tile(int c, int ntiles, bool live,
                                            int lane, int t, int Sk,
                                            const int* __restrict__ k_pos,
                                            const int (&qp)[2],
                                            const bool (&row_in)[2],
                                            int causal, int window,
                                            uint32_t& keep) {
  for (++c; c < ntiles; ++c) {
    const bool kept = tc_tile_keep(c, lane, t, Sk, k_pos, qp, row_in,
                                   causal, window, keep);
    if (__syncthreads_or(kept || !live)) break;
  }
  return c;
}

template <bool B> struct TcFullTile {
  static constexpr bool value = B;
};

template <int D>
__global__ void __launch_bounds__(TC_THREADS)
flash_attention_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            const int* __restrict__ q_pos,
                            const int* __restrict__ k_pos,
                            __nv_bfloat16* __restrict__ out, int Sq, int Sk,
                            int H, int G, long long q_sb, long long q_ss,
                            long long q_sh, long long k_sb, long long k_ss,
                            long long k_sh, long long v_sb, long long v_ss,
                            long long v_sh, float scale, int causal,
                            int window) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int DV = fa_out_cols<D>();  // output columns of this CTA
  constexpr int LD = D + 8;       // padded row, bf16: conflict-free ldmatrix
  constexpr int LDV = DV + 8;     // ... of the v tile
  constexpr int KD = D / 16;      // 16-wide d slices (QKᵀ depth)
  constexpr int KDV = DV / 16;    // 16-wide output slices (P·V pairs)
  constexpr int ND = DV / 8;      // 8-wide output column tiles
  constexpr int CH = D / 8;       // 16-byte chunks a q / k row
  constexpr int CHV = DV / 8;     // ... a v row
  constexpr int TILE = TC_T * LD; // one k stage, bf16
  constexpr int TILEV = TC_T * LDV;  // one v stage
  // a warp keeps its q fragments in registers up to D = 128; above (at
  // D = 192 they would take 48 of a thread's registers beside the 96 of
  // the output accumulators) they are read from the q tile, which stays
  // in shared memory, at each 16-wide slice of QKᵀ instead
  constexpr bool QREG = D <= 128;
  extern __shared__ __align__(16) unsigned char fa_smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(fa_smem);
  __nv_bfloat16* Ks = Qs + TC_Q * LD;           // [stage][64][LD]
  __nv_bfloat16* Vs = Ks + TC_STAGES * TILE;    // [stage][64][LDV]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  // the last query tiles, which see the most keys under a causal mask,
  // are scheduled first (blockIdx.z runs slowest), so short CTAs fill the
  // tail of the grid; blockIdx.x is the head, then which DV columns of it
  const int q0 = (gridDim.z - 1 - blockIdx.z) * TC_Q;
  const int h = blockIdx.x / (D / DV), c0 = blockIdx.x % (D / DV) * DV;
  const int b = blockIdx.y;
  const int hk = h / G;
  const int nq = min(TC_Q, Sq - q0);
  const int ntiles = (Sk + TC_T - 1) / TC_T;
  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh + q0 * q_ss;
  const __nv_bfloat16* kb = k + b * k_sb + hk * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + hk * v_sh + c0;

  // the q tile: one cp.async group, rows past Sq zero-filled
  for (int i = tid; i < TC_Q * CH; i += TC_THREADS) {
    const int r = i / CH, c = i % CH;
    cp_async16(smem_u32(Qs + r * LD + 8 * c),
               qb + (long long)min(r, nq - 1) * q_ss + 8 * c, r < nq);
  }
  cp_async_commit();

  auto issue = [&](int tile, int stage) {   // one k/v tile, one group
    const int k0 = tile * TC_T, nk = min(TC_T, Sk - k0);
    const uint32_t kd = smem_u32(Ks + stage * TILE);
    const uint32_t vd = smem_u32(Vs + stage * TILEV);
    for (int i = tid; i < TC_T * CH; i += TC_THREADS) {
      const int r = i / CH, c = i % CH;
      const long long row = k0 + min(r, nk - 1);
      cp_async16(kd + (uint32_t)(r * LD + 8 * c) * 2u,
                 kb + row * k_ss + 8 * c, r < nk);
      if (CHV == CH || c < CHV)
        cp_async16(vd + (uint32_t)(r * LDV + 8 * c) * 2u,
                   vb + row * v_ss + 8 * c, r < nk);
    }
  };

  // this thread's rows: r = 0, 1 -> warp row g, g + 8
  int qp[2];
  bool row_in[2];
  float m[2], l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = 16 * warp + g + 8 * r;
    row_in[r] = row < nq;
    qp[r] = row_in[r] ? q_pos[q0 + row] : 0;
    m[r] = ATTN_NEG_INF;
    l[r] = 0.f;
  }
  float acc[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  // no row is live yet, so the first tile is always computed
  uint32_t keep_cur = 0, keep_nxt = 0;
  int cur = tc_next_tile(-1, ntiles, false, lane, t, Sk, k_pos, qp, row_in,
                         causal, window, keep_cur);
  if (cur < ntiles) issue(cur, 0);
  cp_async_commit();
  cp_async_wait<1>();                           // the q tile has landed
  __syncthreads();
  uint32_t qf[QREG ? KD : 1][4];
  const uint32_t q_base =
      smem_u32(Qs + (16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1)) * LD +
               8 * (lane >> 4));
  if constexpr (QREG) {
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) ldsm_x4(q_base + 32u * kd, qf[kd]);
  }
  // lane offsets (bytes) of the ldmatrix row addresses in a k / v tile
  const uint32_t k_lane =
      (uint32_t)(((lane & 7) + 8 * (lane >> 4)) * LD + 8 * ((lane >> 3) & 1))
      * 2u;
  const uint32_t v_lane =
      (uint32_t)(((lane & 7) + 8 * ((lane >> 3) & 1)) * LDV +
                 8 * (lane >> 4)) * 2u;

  // scores in log2 units: 2^(s·scale·log2(e) - m) = e^(s·scale - m ln 2)
  const float sc = scale * 1.4426950408889634f;
  float s[8][4];
  // mask and online softmax of row r on the score fragments, s[n][2r + e]
  // being (row r, key 8n + 2t + e). A masked key takes the sentinel; a key
  // past Sk (only in a last, partial tile) takes -inf, so its p is 0
  // whatever the max.
  auto softmax_row = [&](int r, auto full_tile, int nk) {
    const uint32_t kbits = keep_cur >> (16 * r);
    float mx = m[r];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[n][2 * r + e];
        float fill = ATTN_NEG_INF;
        if (!decltype(full_tile)::value && 8 * n + 2 * t + e >= nk)
          fill = -INFINITY;
        x = (kbits >> (2 * n + e)) & 1u ? x * sc : fill;
        mx = fmaxf(mx, x);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float corr = ex2(m[r] - mx);
    float ps = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[n][2 * r + e];
        x = ex2(x - mx);
        ps += x;
      }
    l[r] = l[r] * corr + ps;
#pragma unroll
    for (int i = 0; i < ND; ++i) {
      acc[i][2 * r] *= corr;
      acc[i][2 * r + 1] *= corr;
    }
    m[r] = mx;
  };

  int stage = 0;
  while (cur < ntiles) {
    // decide the next tile and put its copy in flight. A row is live once
    // its max is finite, and will be after `cur` if its quad keeps a key
    // there (its max is then at least that key's finite score).
    uint32_t seen = ((keep_cur & 0xffffu) ? 1u : 0u) |
                    ((keep_cur >> 16) ? 2u : 0u);
    seen |= __shfl_xor_sync(0xffffffffu, seen, 1);
    seen |= __shfl_xor_sync(0xffffffffu, seen, 2);
    const bool live =
        (!row_in[0] || (seen & 1u) || m[0] > 0.5f * ATTN_NEG_INF) &&
        (!row_in[1] || (seen & 2u) || m[1] > 0.5f * ATTN_NEG_INF);
    const int nxt = tc_next_tile(cur, ntiles, live, lane, t, Sk, k_pos, qp,
                                 row_in, causal, window, keep_nxt);
    if (nxt < ntiles) issue(nxt, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();                         // tile `cur` has landed
    __syncthreads();

    const uint32_t ks = smem_u32(Ks + stage * TILE) + k_lane;
    const uint32_t vs = smem_u32(Vs + stage * TILEV) + v_lane;
    const int nk = min(TC_T, Sk - cur * TC_T);

    // s = q kᵀ: 16 rows x 64 keys a warp, eight 16x8 accumulators
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      uint32_t qa[4];
      if constexpr (QREG) {
#pragma unroll
        for (int i = 0; i < 4; ++i) qa[i] = qf[QREG ? kd : 0][i];
      } else {
        ldsm_x4(q_base + 32u * kd, qa);
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t kf[4];
        ldsm_x4(ks + (uint32_t)(16 * np * LD + 16 * kd) * 2u, kf);
        mma_bf16(s[2 * np], qa, kf[0], kf[1]);
        mma_bf16(s[2 * np + 1], qa, kf[2], kf[3]);
      }
    }

    if (nk == TC_T) {
      softmax_row(0, TcFullTile<true>(), nk);
      softmax_row(1, TcFullTile<true>(), nk);
    } else {
      softmax_row(0, TcFullTile<false>(), nk);
      softmax_row(1, TcFullTile<false>(), nk);
    }

    // acc += p v, p split into bf16 hi + lo, 16 keys a step
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t ph[4], pl[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int dp = 0; dp < KDV; ++dp) {
        uint32_t vf[4];
        ldsm_x4_t(vs + (uint32_t)(16 * kk * LDV + 16 * dp) * 2u, vf);
        mma_bf16(acc[2 * dp], pl, vf[0], vf[1]);
        mma_bf16(acc[2 * dp + 1], pl, vf[2], vf[3]);
        mma_bf16(acc[2 * dp], ph, vf[0], vf[1]);
        mma_bf16(acc[2 * dp + 1], ph, vf[2], vf[3]);
      }
    }
    // the next candidate's barrier orders these reads of `stage` before
    // the copy that refills it
    cur = nxt;
    keep_cur = keep_nxt;
    stage ^= 1;
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lt = l[r];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    if (!row_in[r]) continue;
    const float inv = 1.f / fmaxf(lt, 1e-30f);
    __nv_bfloat16* o =
        out + (((long long)b * Sq + q0 + 16 * warp + g + 8 * r) * H + h) * D +
        c0 + 2 * t;
#pragma unroll
    for (int i = 0; i < ND; ++i)
      *reinterpret_cast<__nv_bfloat162*>(o + 8 * i) = __floats2bfloat162_rn(
          acc[i][2 * r] * inv, acc[i][2 * r + 1] * inv);
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <typename T, int D>
static int launch(const void* q, const void* k, const void* v,
                  const int* q_pos, const int* k_pos, void* out, int B,
                  int Sq, int Sk, int H, int K, const long long* st,
                  float scale, int causal, int window, cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(out);
  cudaError_t err;
  if constexpr (sizeof(T) == 2) {
    const size_t smem = tc_smem_bytes<D>();
    err = allow_smem(flash_attention_bf16_kernel<D>, smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid(H * (D / fa_out_cols<D>()), B, (Sq + TC_Q - 1) / TC_Q);
    flash_attention_bf16_kernel<D><<<grid, TC_THREADS, smem, stream>>>(
        qt, kt, vt, q_pos, k_pos, ot, Sq, Sk, H, H / K, st[0], st[1], st[2],
        st[3], st[4], st[5], st[6], st[7], st[8], scale, causal, window);
  } else {
    const size_t smem = fa_smem_bytes<D>();
    err = allow_smem(flash_attention_f32_kernel<D>, smem);
    if (err != cudaSuccess) return (int)err;
    const int heads = H * (D / fa_out_cols<D>());
    if (heads > 65535) return (int)cudaErrorInvalidValue;
    dim3 grid((Sq + FA_Q - 1) / FA_Q, heads, B);
    flash_attention_f32_kernel<D><<<grid, FA_THREADS, smem, stream>>>(
        qt, kt, vt, q_pos, k_pos, ot, Sq, Sk, H, H / K, st[0], st[1], st[2],
        st[3], st[4], st[5], st[6], st[7], st[8], scale, causal, window);
  }
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
    case 160: return launch<T, 160>(q, k, v, q_pos, k_pos, out, B, Sq, Sk,
                                    H, K, st, scale, causal, window, s);
    case 192: return launch<T, 192>(q, k, v, q_pos, k_pos, out, B, Sq, Sk,
                                    H, K, st, scale, causal, window, s);
    case 256: return launch<T, 256>(q, k, v, q_pos, k_pos, out, B, Sq, Sk,
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
