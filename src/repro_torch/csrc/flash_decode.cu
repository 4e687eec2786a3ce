// Flash-decode: one query token per sequence against a KV cache, split
// over the cache length into online-softmax partials (m, l, acc), then an
// exact combine in split order. One launch a call; deterministic, no
// atomics, no global scratch.
//
// Replaces the Pallas TPU kernel `flash_decode_partials` (_fd_kernel) of
// src/repro/kernels/flash_decode/kernel.py and its `combine_partials`.
// Decode offers no query parallelism, so the cache length is split. A
// cluster of C CTAs (grid (C, K, B), cluster (C, 1, 1)) owns one (batch,
// kv head) and all G = H / K query heads of it (GQA without a repeat;
// nothing assumes G a power of two: the heads are loops of G, their
// shared-memory arrays G·D or G·32 floats, so G = 3 and G = 7 run as
// written);
// CTA r takes splits [r·spc, (r+1)·spc) (spc = ceil(n_splits / C)), each
// split giving its own partial, so the arithmetic keeps repro's
// structure: partials per split, then the combine in split order.
// Validity is data: k_pos (B, S) int32 (pads at <= -1e8; causal against
// q_pos (B,); an optional window); the decode path folds the window into
// k_pos and passes window = 0. Masked scores take the finite sentinel
// -1e30; keys past the split get p = 0. A split whose keys are all masked
// keeps m = -1e30 and gets weight exp(-1e30 - m_max) = 0 in the combine.
//
// Bound: bytes. At the LM decode shape (B=8, S=1056, K=8, D=80, bf16) the
// valid keys' k/v rows are 21.4 MB: 6.4 us at 3.35 TB/s; the arithmetic
// (4·D FLOP per (head, key)) is 85 MFLOP, ~1.3 us of f32 FFMA.
//
// Design for that, on Hopper:
// - a producer warp streams the CTA's keys into a ring of `stages` stages
//   of 32 keys with the Tensor Memory Accelerator: one tensor copy
//   (cp.async.bulk.tensor, a (D, 1, 32, 1) box of the (D, K, S, B) cache)
//   for the stage's k rows and one for its v rows, so the whole ring is in
//   flight from the first cycle; each stage has a `full` and an `empty`
//   mbarrier. A tensor copy moves 32 rows for one request; one bulk copy
//   a 160-byte row, or 16-byte cp.async, kept too few bytes in flight an
//   SM on an H100 (PERF.md §6). Keys past the cache end come in as
//   zeros; keys past the split (the next split's rows) get p = 0; pad
//   keys are loaded and masked (the decode cache has few);
// - W consumer warps take the stages of a split in turn (stage c to warp
//   c mod W; the ring is a multiple of W stages, so a warp waits on a
//   stage's next use only once its last use has landed: the waits tell
//   phases apart by parity alone). W is 8 where such a CTA fits its
//   shared memory (the LM's bf16, G=4, D=80 among them; stablelm-12b's
//   bf16, G=4, D=160), else 4 (gemma3-12b's bf16, G=2, D=256: a ring of
//   4 stages, 128 KB): a stage's arithmetic takes a warp longer than the
//   stage takes to land, so more warps an SM share it (PERF.md §6). In
//   f32 at D=256 a stage is 64 KB and four do not fit beside the rest, so
//   W is 2 with a ring of 2 stages, one a warp (the same parity-only
//   waits: the ring is still a multiple of W). One key a lane for the
//   scores (q in shared memory as f32, read as broadcast vectors; k_pos
//   loaded a stage ahead), an online softmax per head by shuffles, and
//   P·V with each lane owning the columns lane + 32t; all in f32 FFMA. At a split's end the warps'
//   (m, l, acc) merge in warp order into the split's partial, kept in
//   shared memory;
// - the combine folded in: after a cluster barrier each CTA gathers every
//   split's m and l of its cluster, computes its share of the G·D outputs
//   reading the splits' acc in split order from the cluster's shared
//   memory (the max first, then the weighted sums, as combine_partials
//   does), writes them in q's dtype and meets the others at a second
//   cluster barrier before it exits;
// - the planner (kernels/flash_decode/ops.py) picks C <= 16 and the ring
//   depth so that all CTAs fit in one wave (from
//   cudaOccupancyMaxActiveClusters, flash_decode_max_active_clusters) with
//   the fewest keys on the busiest SM.
#include <cooperative_groups.h>
#include <cuda.h>
#include <cudaTypedefs.h>

#include <mutex>

#include "attn_common.cuh"

namespace cg = cooperative_groups;

constexpr int FD_MAX_WARPS = 8;                  // consumer warps, at most
constexpr int FD_KEYS = 32;                      // keys a stage, one a lane
constexpr int FD_MAX_STAGES = 16;
constexpr int FD_MAX_CLUSTER = 16;
constexpr int FD_BARRIER_BYTES = 2 * FD_MAX_STAGES * 8;   // full + empty
constexpr int FD_MAX_DEVICES = 64;               // function attributes kept

// A stage: 32 k rows, then 32 v rows, D values each, dense.
template <typename T, int D>
__host__ __device__ constexpr int fd_tile_bytes() {
  return FD_KEYS * D * (int)sizeof(T);
}

// The ring: `stages` stages; after the main loop it holds every split's m
// and l of the cluster for the combine.
template <typename T, int D>
__host__ __device__ constexpr size_t fd_ring_bytes(int stages, int G,
                                                   int spc) {
  return (size_t)stages * 2 * fd_tile_bytes<T, D>() >
                 (size_t)2 * FD_MAX_CLUSTER * spc * G * sizeof(float)
             ? (size_t)stages * 2 * fd_tile_bytes<T, D>()
             : (size_t)2 * FD_MAX_CLUSTER * spc * G * sizeof(float);
}

// Dynamic shared memory with W consumer warps: the ring (1024-byte
// aligned), then f32 arrays: q [G][D], the warps' p [warp][G][32], the
// warps' m, l [warp][G] and acc [warp][G][D] at a split's end, the
// splits' m, l [spc][G] and acc [spc][G][D]; then the mbarriers.
template <typename T, int G, int D>
__host__ __device__ constexpr size_t fd_smem_bytes(int W, int stages,
                                                   int spc) {
  return fd_ring_bytes<T, D>(stages, G, spc) +
         sizeof(float) * ((size_t)G * D + (size_t)W * G * FD_KEYS +
                          (size_t)W * G * (D + 2) + (size_t)spc * G * (D + 2)) +
         FD_BARRIER_BYTES;
}

// Consumer warps of an instantiation: 8 where a CTA with a ring of one
// stage a warp and 4 splits fits the 227 KB a block may take, else 4
// where that fits with 4, else 2.
template <typename T, int G, int D>
__host__ __device__ constexpr int fd_warps() {
  return fd_smem_bytes<T, G, D>(FD_MAX_WARPS, FD_MAX_WARPS, 4) <= 232448
             ? FD_MAX_WARPS
         : fd_smem_bytes<T, G, D>(4, 4, 4) <= 232448 ? 4
                                                      : 2;
}

struct FdArgs {
  CUtensorMap tk, tv;        // k, v: (D, K, S, B) in (D, 1, 32, 1) boxes
  const void* q;
  const int* q_pos;
  const int* k_pos;
  void* out;
  int S, n_splits, per_split, stages, window;
  float scale;
  long long q_sb, q_sh, kp_sb, qp_sb;
};

// ---------------------------------------------------------------------------
// mbarriers and tensor copies
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n .reg .b64 st;\n mbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::
          "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "{\n .reg .b64 st;\n"
      " mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
// Wait until the phase of `bar` with this parity has completed (acquire).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}
// The box of `map` at (c0, c1, c2, c3) into shared memory at `dst`,
// completion counted in bytes on `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            int c1, int c2, int c3,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(smem_u32(bar))
      : "memory");
}
// Finite floats as ints of the same order (negatives' magnitude bits
// flipped), so that a warp takes their max in one __reduce_max_sync; the
// map is its own inverse.
__device__ __forceinline__ int float_to_ordered(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}
__device__ __forceinline__ float ordered_to_float(int i) {
  return __int_as_float(i >= 0 ? i : i ^ 0x7fffffff);
}
// the W consumer warps' barrier (the producer warp does not take part)
template <int W>
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(32 * W) : "memory");
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

// With 8 consumer warps, registers for two CTAs an SM (113 a thread).
template <typename T, int G, int D>
__global__ void __launch_bounds__(32 * (fd_warps<T, G, D>() + 1),
                                  fd_warps<T, G, D>() > 4 ? 2 : 1)
flash_decode_kernel(const __grid_constant__ FdArgs a) {
  constexpr int W = fd_warps<T, G, D>();       // consumer warps
  static_assert(fd_smem_bytes<T, G, D>(W, W, 1) <= 232448,
                "no ring of one stage a warp fits this instantiation");
  constexpr int NT = 32 * (W + 1);            // + the producer warp
  constexpr int TILE = fd_tile_bytes<T, D>();
  constexpr int STAGE = 2 * TILE;
  constexpr int RB = D * (int)sizeof(T);  // a staged row
  constexpr int V = Row16<T>::n;          // elements per 16-byte load
  constexpr int NC = (D + 31) / 32;       // output columns per lane
  extern __shared__ __align__(1024) unsigned char smem[];
  unsigned char* ring = smem;
  const int stages = a.stages;
  const int C = gridDim.x, rank = blockIdx.x;   // the cluster spans x
  const int spc = (a.n_splits + C - 1) / C;
  float* Qs = reinterpret_cast<float*>(ring +
                                      fd_ring_bytes<T, D>(stages, G, spc));
  float* Ps = Qs + G * D;                // [warp][G][32]
  float* Wm = Ps + W * G * FD_KEYS;      // [warp][G]
  float* Wl = Wm + W * G;                // [warp][G]
  float* Wa = Wl + W * G;                // [warp][G][D]
  float* Pm = Wa + W * G * D;            // [spc][G]
  float* Pl = Pm + spc * G;              // [spc][G]
  float* Pa = Pl + spc * G;              // [spc][G][D]
  uint64_t* full = reinterpret_cast<uint64_t*>(Pa + spc * G * D);
  uint64_t* empty = full + FD_MAX_STAGES;

  const int hk = blockIdx.y, b = blockIdx.z;
  const int H = gridDim.y * G;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int S = a.S, per_split = a.per_split;
  const int s_first = rank * spc;
  const int n_local = max(0, min(a.n_splits, s_first + spc) - s_first);

  if (tid == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(&full[i], 1);         // the producer's arrive.expect_tx
      mbar_init(&empty[i], 1);        // the consuming warp's lane 0
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the G query heads of this kv head are contiguous in h = hk * G + g
  stage_rows<T, D, D>(Qs,
                      static_cast<const T*>(a.q) + b * a.q_sb +
                          (long long)hk * G * a.q_sh,
                      a.q_sh, G, G);
  __syncthreads();

  if (warp == W) {
    // producer: the CTA's splits in order, 32 keys a stage, two tensor
    // copies a stage
    if (lane == 0) {
      int chunk = 0;
      for (int ls = 0; ls < n_local; ++ls) {
        const int lo = (s_first + ls) * per_split;
        const int hi = min(S, lo + per_split);
        for (int key0 = lo; key0 < hi; key0 += FD_KEYS, ++chunk) {
          const int slot = chunk % stages;
          mbar_wait(&empty[slot], ((chunk / stages) & 1) ^ 1);
          const uint32_t st = smem_u32(ring + (size_t)slot * STAGE);
          mbar_arrive_expect_tx(&full[slot], STAGE);
          tma_load_4d(st, &a.tk, 0, hk, key0, b, &full[slot]);
          tma_load_4d(st + TILE, &a.tv, 0, hk, key0, b, &full[slot]);
        }
      }
    }
  } else {
    // consumers: stage c of a split goes to warp c mod W
    const int* kpb = a.k_pos + b * a.kp_sb;
    const int qp = a.q_pos[b * a.qp_sb];
    float* pw = Ps + warp * G * FD_KEYS;
    int chunk0 = 0;                     // the split's first stage index
    for (int ls = 0; ls < n_local; ++ls) {
      const int lo = (s_first + ls) * per_split;
      const int hi = min(S, lo + per_split);
      const int n_chunks = hi > lo ? (hi - lo + FD_KEYS - 1) / FD_KEYS : 0;
      float m[G], l[G], acc[G][NC];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        m[g] = ATTN_NEG_INF;
        l[g] = 0.f;
#pragma unroll
        for (int t = 0; t < NC; ++t) acc[g][t] = 0.f;
      }
      // k_pos one stage ahead of its use
      int kp_next = warp < n_chunks
                        ? kpb[min(lo + FD_KEYS * warp + lane, hi - 1)]
                        : 0;
      for (int c = warp; c < n_chunks; c += W) {
        const int key = lo + FD_KEYS * c + lane;
        const bool in = key < hi;
        const bool keep = in && attn_keep(qp, kp_next, 1, a.window);
        if (c + W < n_chunks)
          kp_next = kpb[min(key + FD_KEYS * W, hi - 1)];
        const int chunk = chunk0 + c, slot = chunk % stages;
        mbar_wait(&full[slot], (chunk / stages) & 1);
        const unsigned char* st = ring + (size_t)slot * STAGE;

        // scores of this lane's key against the G heads
        float sc[G];
#pragma unroll
        for (int g = 0; g < G; ++g) sc[g] = 0.f;
        const T* kr = reinterpret_cast<const T*>(st + lane * RB);
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
        // online softmax per head over the stage's 32 keys: the warp's max
        // in one integer reduction; l summed per lane (each lane its own
        // keys' p), across the warp only at the split's end
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float s = keep ? sc[g] * a.scale : ATTN_NEG_INF;
          const float mx = ordered_to_float(__reduce_max_sync(
              0xffffffffu, float_to_ordered(fmaxf(m[g], s))));
          const float p = in ? expf(s - mx) : 0.f;
          const float corr = expf(m[g] - mx);
          l[g] = l[g] * corr + p;
#pragma unroll
          for (int t = 0; t < NC; ++t) acc[g][t] *= corr;
          m[g] = mx;
          pw[g * FD_KEYS + lane] = p;
        }
        __syncwarp();
        // P·V in key order; lane owns the columns lane + 32t
#pragma unroll 2
        for (int t0 = 0; t0 < FD_KEYS; t0 += 4) {
          float vv[4][NC];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const T* vr =
                reinterpret_cast<const T*>(st + TILE + (t0 + i) * RB);
#pragma unroll
            for (int t = 0; t < NC; ++t)
              vv[i][t] = lane + 32 * t < D ? to_f32(vr[lane + 32 * t]) : 0.f;
          }
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const float4 p4 =
                *reinterpret_cast<const float4*>(pw + g * FD_KEYS + t0);
#pragma unroll
            for (int t = 0; t < NC; ++t) {
              acc[g][t] = fmaf(p4.x, vv[0][t], acc[g][t]);
              acc[g][t] = fmaf(p4.y, vv[1][t], acc[g][t]);
              acc[g][t] = fmaf(p4.z, vv[2][t], acc[g][t]);
              acc[g][t] = fmaf(p4.w, vv[3][t], acc[g][t]);
            }
          }
        }
        __syncwarp();                   // stage and p consumed
        if (lane == 0) mbar_arrive(&empty[slot]);
      }
      chunk0 += n_chunks;

      // merge the warps' partials in warp order into the split's; an empty
      // split gives m = -1e30, l = 0, acc = 0
#pragma unroll
      for (int g = 0; g < G; ++g) {
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          l[g] += __shfl_xor_sync(0xffffffffu, l[g], o);
        if (lane == 0) {
          Wm[warp * G + g] = m[g];
          Wl[warp * G + g] = l[g];
        }
#pragma unroll
        for (int t = 0; t < NC; ++t)
          if (lane + 32 * t < D)
            Wa[(warp * G + g) * D + lane + 32 * t] = acc[g][t];
      }
      consumers_sync<W>();
      for (int o = tid; o < G * (D + 1); o += 32 * W) {
        const int g = o / (D + 1), d = o % (D + 1);   // d == D: m and l
        float m_cta = Wm[g];
#pragma unroll
        for (int w = 1; w < W; ++w) m_cta = fmaxf(m_cta, Wm[w * G + g]);
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < W; ++w) {
          const float wt = expf(Wm[w * G + g] - m_cta);
          s += (d < D ? Wa[(w * G + g) * D + d] : Wl[w * G + g]) * wt;
        }
        if (d < D) {
          Pa[(ls * G + g) * D + d] = s;
        } else {
          Pm[ls * G + g] = m_cta;
          Pl[ls * G + g] = s;
        }
      }
      consumers_sync<W>();                 // W* free for the next split
    }
  }


  // the combine: out = sum_s acc_s w_s / max(sum_s l_s w_s, 1e-30) with
  // w_s = exp(m_s - max_s m_s), splits in order, read from their CTAs;
  // every split's m and l first gathered into the (spent) ring
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int n = a.n_splits;
  float* Cm = reinterpret_cast<float*>(ring);   // [n][G]
  float* Cl = Cm + n * G;                       // [n][G]
  for (int i = tid; i < n * G; i += NT) {
    const int s = i / G, k = (s % spc) * G + i % G;
    Cm[i] = cluster.map_shared_rank(Pm, s / spc)[k];
    Cl[i] = cluster.map_shared_rank(Pl, s / spc)[k];
  }
  __syncthreads();
  T* ob = static_cast<T*>(a.out) + ((long long)b * H + hk * G) * D;
  for (int o = rank * NT + tid; o < G * D; o += C * NT) {
    const int g = o / D, d = o % D;
    float m_max = Cm[g];
    for (int s = 1; s < n; ++s) m_max = fmaxf(m_max, Cm[s * G + g]);
    float l_tot = 0.f, a_tot = 0.f;
#pragma unroll 16
    for (int s = 0; s < n; ++s) {
      const float w = expf(Cm[s * G + g] - m_max);
      l_tot += Cl[s * G + g] * w;
      a_tot += cluster.map_shared_rank(Pa, s / spc)[((s % spc) * G + g) * D +
                                                    d] * w;
    }
    ob[g * D + d] = from_f32<T>(a_tot / fmaxf(l_tot, 1e-30f));
  }
  cluster.sync();                       // partials read: CTAs may exit
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <typename T, int G, int D>
struct Inst {
  using type = T;
  static constexpr int g = G, d = D;
};

// Call f(Inst<T, G, D>{}) for the instantiation of (dtype, G, D);
// dtype 0 = f32, 1 = bf16. Head dims up to 128 are instantiated at every
// G; 160 and 256 (stablelm-12b, gemma3-12b) at G = 1, 2, 4, 8 only, which
// keeps the build's time (kernels/flash_decode/ops.py: INSTANCES).
template <typename F>
static int dispatch(int dtype, int G, int D, F&& f) {
#define FD_D(TT, GG, DD) \
  case DD:               \
    return f(Inst<TT, GG, DD>{});
#define FD_DIMS(TT, GG)                                                  \
  FD_D(TT, GG, 16)                                                       \
  FD_D(TT, GG, 32)                                                       \
  FD_D(TT, GG, 64)                                                       \
  FD_D(TT, GG, 80)                                                       \
  FD_D(TT, GG, 96)                                                       \
  FD_D(TT, GG, 128)
#define FD_G(TT, GG)                                                     \
  case GG:                                                               \
    switch (D) { FD_DIMS(TT, GG) }                                       \
    return (int)cudaErrorInvalidValue;
#define FD_G_WIDE(TT, GG)                                                \
  case GG:                                                               \
    switch (D) {                                                         \
      FD_DIMS(TT, GG)                                                    \
      FD_D(TT, GG, 160)                                                  \
      FD_D(TT, GG, 256)                                                  \
    }                                                                    \
    return (int)cudaErrorInvalidValue;
#define FD_T(TT)                                                         \
  switch (G) {                                                           \
    FD_G_WIDE(TT, 1)                                                     \
    FD_G_WIDE(TT, 2)                                                     \
    FD_G(TT, 3)                                                          \
    FD_G_WIDE(TT, 4)                                                     \
    FD_G(TT, 7)                                                          \
    FD_G_WIDE(TT, 8)                                                     \
    FD_G(TT, 16)                                                         \
  }                                                                      \
  return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    FD_T(float)
  }
  if (dtype == 1) {
    FD_T(__nv_bfloat16)
  }
#undef FD_T
#undef FD_G_WIDE
#undef FD_G
#undef FD_DIMS
#undef FD_D
  return (int)cudaErrorInvalidValue;
}

// The kernel of `I` opted into its shared memory and non-portable
// cluster sizes (C > 8), and a launch configuration for it. The function's
// attributes are set once per instantiation and device, and again only
// when a plan needs more shared memory than any before it.
template <typename I>
static cudaError_t configure(cudaLaunchConfig_t* cfg,
                             cudaLaunchAttribute* attr, dim3 grid,
                             int cluster, int stages, int spc,
                             cudaStream_t stream) {
  auto fn = flash_decode_kernel<typename I::type, I::g, I::d>;
  constexpr int W = fd_warps<typename I::type, I::g, I::d>();
  if (stages < W || stages > FD_MAX_STAGES || stages % W != 0)
    return cudaErrorInvalidValue;    // a ring of a multiple of W stages
  const size_t smem =
      fd_smem_bytes<typename I::type, I::g, I::d>(W, stages, spc);
  static std::mutex mu;
  static size_t allowed[FD_MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  {
    std::lock_guard<std::mutex> lock(mu);
    if (dev >= FD_MAX_DEVICES || smem > allowed[dev]) {
      err = cudaFuncSetAttribute(
          fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err == cudaSuccess) err = allow_smem(fn, smem);
      if (err == cudaSuccess && dev < FD_MAX_DEVICES) allowed[dev] = smem;
    }
  }
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = grid;
  cfg->blockDim = dim3(32 * (W + 1));
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return err;
}

static bool bad_plan(int cluster, int stages, int n_splits) {
  return cluster < 1 || cluster > FD_MAX_CLUSTER || stages < 1 ||
         stages > FD_MAX_STAGES || n_splits < 1;
}

// cudaOccupancyMaxActiveClusters of clusters of `cluster` CTAs, `stages`
// ring stages and `spc` splits a CTA, into *n (0: the card cannot place
// one).
extern "C" int flash_decode_max_active_clusters(int dtype, int G, int D,
                                                int cluster, int stages,
                                                int spc, int* n) {
  if (bad_plan(cluster, stages, spc)) return (int)cudaErrorInvalidValue;
  return dispatch(dtype, G, D, [&](auto inst) {
    using I = decltype(inst);
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    cudaError_t err = configure<I>(&cfg, &attr, dim3(cluster), cluster,
                                   stages, spc, 0);
    if (err != cudaSuccess) {
      // a shared-memory size the card does not have: nothing fits
      *n = 0;
      cudaGetLastError();
      return (int)cudaSuccess;
    }
    return (int)cudaOccupancyMaxActiveClusters(
        n, flash_decode_kernel<typename I::type, I::g, I::d>, &cfg);
  });
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no libcuda
// at link time)
static PFN_cuTensorMapEncodeTiled_v12000 encode_tiled() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault,
                                         &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }();
  return fn;
}

// A (B, S, K, D) cache with element strides (sb, ss, sh, 1) as a 4-d
// tensor (D, K, S, B) read in (D, 1, 32, 1) boxes; rows past S read as 0.
static cudaError_t encode_cache(CUtensorMap* map, const void* base,
                                int dtype, int B, int S, int K, int D,
                                long long sb, long long ss, long long sh) {
  auto encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t isz = dtype == 0 ? 4 : 2;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)K, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {sh * isz, ss * isz, sb * isz};
  const cuuint32_t box[4] = {(cuuint32_t)D, 1, FD_KEYS, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map,
      dtype == 0 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      4, const_cast<void*>(base), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// q (B,1,H,D) with strides (q_sb, ., q_sh, 1); k/v (B,S,K,D) with strides
// (sb, ss, sh, 1), rows 16-byte aligned; k_pos (B,S) int32 with batch
// stride kp_sb (0 when shared) and unit position stride; q_pos (B,) with
// stride qp_sb; out (B,1,H,D) contiguous; (D, G = H / K) an instantiated
// pair (dispatch);
// split s covers [s·per_split, (s+1)·per_split) ∩ [0, S); `cluster` CTAs
// a (batch, kv head), `stages` ring stages; dtype 0 = f32, 1 = bf16.
extern "C" int flash_decode_launch(
    const void* q, const void* k, const void* v, const int* q_pos,
    const int* k_pos, void* out, int B, int S, int H, int K, int D,
    int n_splits, int per_split, int cluster, int stages, long long q_sb,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long kp_sb,
    long long qp_sb, float scale, int window, int dtype, void* stream) {
  if (K < 1 || H % K != 0 || per_split < 1 ||
      bad_plan(cluster, stages, n_splits))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  FdArgs args{};
  cudaError_t err = encode_cache(&args.tk, k, dtype, B, S, K, D, k_sb, k_ss,
                                 k_sh);
  if (err == cudaSuccess)
    err = encode_cache(&args.tv, v, dtype, B, S, K, D, v_sb, v_ss, v_sh);
  if (err != cudaSuccess) return (int)err;
  args.q = q;
  args.q_pos = q_pos;
  args.k_pos = k_pos;
  args.out = out;
  args.S = S;
  args.n_splits = n_splits;
  args.per_split = per_split;
  args.stages = stages;
  args.window = window;
  args.scale = scale;
  args.q_sb = q_sb;
  args.q_sh = q_sh;
  args.kp_sb = kp_sb;
  args.qp_sb = qp_sb;
  const int spc = (n_splits + cluster - 1) / cluster;
  return dispatch(dtype, H / K, D, [&](auto inst) {
    using I = decltype(inst);
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    cudaError_t e =
        configure<I>(&cfg, &attr, dim3(cluster, K, B), cluster, stages, spc,
                     static_cast<cudaStream_t>(stream));
    if (e != cudaSuccess) return (int)e;
    e = cudaLaunchKernelEx(
        &cfg, flash_decode_kernel<typename I::type, I::g, I::d>, args);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
  });
}
