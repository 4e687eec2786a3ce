// Masked segment-sum of padded graph batches, deterministic, no atomics.
//
// Replaces the Pallas TPU kernels `segment_sum_batched` (_ss_batched_kernel)
// and `segment_sum_2d` (_ss_kernel) of src/repro/kernels/segment_sum/
// kernel.py. The TPU kernel turns scatter-add into a one-hot membership
// matmul because the TPU has no atomics and its grid runs in order on one
// core, carrying the node accumulator from one edge block to the next.
// Hopper blocks run in parallel and in no order, and float atomics would
// make the sum order (and so the bits) change from run to run, which the
// serving contract (batched rows bitwise equal to a lone request) forbids.
//
// Design: one CTA per (column tile of 128, node block, graph). The CTA
// stages a window of `dst` in shared memory and keeps (block_n x 128) f32
// accumulators there, one per edge group. Each thread owns one column of
// its group's accumulator and walks its group's share of the window in
// index order, adding msg[b, e, col] into acc[dst[e] - node0][col] when dst
// falls in its node block; the group partials are added in group order at
// the end. No two threads ever touch one address, so the order of every
// sum is fixed by the tiling, not by scheduling. Edges with dst >= n_nodes
// (masked, or the ragged pad sentinel) match no row and are never loaded.
//
// Bound: memory. Each message is read once by the CTA of its column tile
// (node blocks > 1 re-read the dst window, not the messages) and the output
// written once: at (B=8, E=2048, A=64, F=866) f32 that is ~58.6 MB, ~17 us
// at 3.35 TB/s. What stands in the way is latency: each thread's walk is a
// chain of loads, and at B=8, F=866 there are only 56 column-tile CTAs.
// The wrapper splits the nodes into blocks until the grid covers the SMs
// (each CTA loads only its own nodes' messages), and edge groups (up to 8
// per CTA, as shared memory allows) and an unroll of 8 keep more loads in
// flight per SM.
#include "common.cuh"

constexpr int SS_COLS = 128;   // column tile == threads per group
constexpr int SS_UNROLL = 8;

// blockDim = (128, groups). Group g walks its contiguous share of each
// staged window in edge order into its own (block_n x 128) partial; the
// partials are summed in group order at the end. Every (group, row, column)
// has one owner thread, so the order of every sum is fixed by (block_e,
// groups) alone — no atomics, the same bits on every run.
template <typename T>
__global__ void __launch_bounds__(1024)
segment_sum_kernel(const T* __restrict__ msg, const int32_t* __restrict__ dst,
                   T* __restrict__ out, int E, int F, int n_nodes,
                   int block_n, int block_e) {
  extern __shared__ float smem[];
  const int groups = blockDim.y;
  float* acc = smem;                       // [groups][block_n][128]
  int* dst_s = reinterpret_cast<int*>(smem + groups * block_n * SS_COLS);

  const int tid = threadIdx.x, g = threadIdx.y;
  const int flat = g * SS_COLS + tid, nthreads = groups * SS_COLS;
  const int col = blockIdx.x * SS_COLS + tid;
  const int node0 = blockIdx.y * block_n;
  const int b = blockIdx.z;
  const int nb = min(block_n, n_nodes - node0);
  const bool active = col < F;
  float* my = acc + g * block_n * SS_COLS;

  for (int r = 0; r < nb; ++r) my[r * SS_COLS + tid] = 0.f;

  const T* mcol = msg + (size_t)b * E * F + col;
  const int32_t* drow = dst + (size_t)b * E;

  for (int e0 = 0; e0 < E; e0 += block_e) {
    const int ne = min(block_e, E - e0);
    __syncthreads();                       // previous window consumed
    for (int i = flat; i < ne; i += nthreads) {
      const int d = drow[e0 + i] - node0;
      dst_s[i] = (d >= 0 && d < nb) ? d : -1;
    }
    __syncthreads();
    if (!active) continue;
    const int share = (ne + groups - 1) / groups;
    const int lo = min(ne, g * share), hi = min(ne, lo + share);
    const T* m = mcol + (size_t)e0 * F;
    int i = lo;
    for (; i + SS_UNROLL <= hi; i += SS_UNROLL) {
      int d[SS_UNROLL];
      float v[SS_UNROLL];
#pragma unroll
      for (int u = 0; u < SS_UNROLL; ++u) {
        d[u] = dst_s[i + u];
        v[u] = d[u] >= 0 ? to_f32(m[(size_t)(i + u) * F]) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < SS_UNROLL; ++u)
        if (d[u] >= 0) my[d[u] * SS_COLS + tid] += v[u];
    }
    for (; i < hi; ++i) {
      const int d = dst_s[i];
      if (d >= 0) my[d * SS_COLS + tid] += to_f32(m[(size_t)i * F]);
    }
  }
  __syncthreads();
  if (!active) return;
  T* o = out + ((size_t)b * n_nodes + node0) * F + col;
  for (int r = g; r < nb; r += groups) {
    float v = 0.f;
    for (int q = 0; q < groups; ++q) v += acc[(q * block_n + r) * SS_COLS + tid];
    o[(size_t)r * F] = from_f32<T>(v);
  }
}

template <typename T>
static int launch(const void* msg, const int32_t* dst, void* out, int B,
                  int E, int F, int n_nodes, int block_n, int block_e,
                  int groups, cudaStream_t stream) {
  const size_t smem = (size_t)groups * block_n * SS_COLS * sizeof(float) +
                      (size_t)block_e * sizeof(int);
  cudaError_t err = allow_smem(segment_sum_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((F + SS_COLS - 1) / SS_COLS, (n_nodes + block_n - 1) / block_n, B);
  dim3 block(SS_COLS, groups);
  segment_sum_kernel<T><<<grid, block, smem, stream>>>(
      static_cast<const T*>(msg), dst, static_cast<T*>(out), E, F, n_nodes,
      block_n, block_e);
  return (int)cudaGetLastError();
}

// msg (B,E,F) and out (B,n_nodes,F) contiguous, dtype 0 = f32, 1 = bf16;
// dst (B,E) int32 with >= n_nodes for edges that contribute nothing.
extern "C" int segment_sum_launch(const void* msg, const int32_t* dst,
                                  void* out, int B, int E, int F, int n_nodes,
                                  int block_n, int block_e, int groups,
                                  int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (groups < 1 || groups > 8) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(msg, dst, out, B, E, F, n_nodes, block_n, block_e,
                         groups, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(msg, dst, out, B, E, F, n_nodes, block_n,
                                 block_e, groups, s);
  return (int)cudaErrorInvalidValue;
}
