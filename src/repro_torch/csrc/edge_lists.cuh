// Per-node edge lists in edge order, built in shared memory by one CTA for
// one graph: the EGNN edge kernels (csrc/egnn_edge.cu, forward;
// csrc/egnn_edge_bwd.cu, backward) share these steps.
//
//   1. each warp counts its contiguous share of the graph's 32-edge chunks
//      per node: keys of 8 chunks loaded at once (`chunk_keys`), a
//      __match_any_sync per chunk, the lowest lane of each group of equal
//      keys adding the group's size to cnt[warp][node];
//   2. one warp turns the counts into list offsets (`list_offsets`);
//   3. the same walk again places each edge at cnt[warp][node] plus its
//      rank among the lanes of its group, then advances the cursor.
//
// A node's list then holds its edges in edge order: warps take chunks in
// order, lanes within a chunk in order.
#pragma once

#include "common.cuh"

constexpr unsigned FULL = 0xffffffffu;

// Load 8 chunks' (dst, clamped src) keys of the warp's edges at once; -1
// for an edge past E or with dst out of range.
__device__ __forceinline__ void chunk_keys(const int32_t* dr,
                                           const int32_t* sr, int A, int E,
                                           int ch, int ch1, int (&kd)[8],
                                           int (&ks)[8]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int e = (ch + j) * 32 + lane;
    const bool in = ch + j < ch1 && e < E;
    kd[j] = in ? dr[e] : -1;
    ks[j] = in ? sr[e] : 0;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const bool valid = kd[j] >= 0 && kd[j] < A;
    ks[j] = valid ? min(ks[j], A - 1) : -1;
    kd[j] = valid ? kd[j] : -1;
  }
}

// One warp: the exclusive scan of WARPS warps' counts cnt[w][a] over nodes
// and warps. Each lane takes a run of nodes; cnt[w][a] becomes warp w's
// first slot in node a's list, off[a] the list's first slot and off[A] the
// number of listed edges.
template <int WARPS>
__device__ __forceinline__ void list_offsets(int* cnt, int* off, int A) {
  const int lane = threadIdx.x & 31;
  const int per = (A + 31) / 32;
  const int a0 = min(A, lane * per), a1 = min(A, a0 + per);
  int run = 0;
  for (int a = a0; a < a1; ++a)
    for (int w = 0; w < WARPS; ++w) run += cnt[w * A + a];
  int incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += v;
  }
  int base = incl - run;
  for (int a = a0; a < a1; ++a) {
    off[a] = base;
    for (int w = 0; w < WARPS; ++w) {
      const int n = cnt[w * A + a];
      cnt[w * A + a] = base;
      base += n;
    }
  }
  if (lane == 31) off[A] = incl;
}
