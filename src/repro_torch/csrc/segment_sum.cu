// Masked segment-sum of padded graph batches, deterministic, no atomics.
//
// Replaces the Pallas TPU kernels `segment_sum_2d` (kernel.py:136) and
// `segment_sum_batched` (kernel.py:183) of src/repro/kernels/segment_sum/.
// The TPU kernel turns scatter-add into a one-hot membership matmul because
// the TPU has no atomics and its grid runs in order on one core, carrying
// the node accumulator from one edge block to the next. Hopper blocks run
// in parallel and in no order, and float atomics would make the sum order
// (and so the bits) change from run to run, which the serving contract
// (batched rows bitwise equal to a lone request) forbids.
//
//   out[b, n, :] = sum of msg[b, e, :] over the edges e with dst[b, e] == n,
//                  0 <= n < n_nodes; f32 sums, output in the message dtype.
//
// Design: one CTA per (column chunk, block of `block_n` nodes, graph). The
// CTA takes the graph's dst in windows of `block_e` and compacts the edges
// that fall in its nodes into one list per node, in edge order: each warp
// reads a contiguous slice of the window (eight 32-entry chunks in flight)
// and counts its matches per node — for one node a ballot per chunk, kept
// in shared memory as the chunk's mask, and __popc; for several, the
// staged local node and __match_any_sync — an exclusive scan over the
// warps gives every warp its place, and a second walk over the masks (or
// the staged nodes) writes the edge indices there. Then each thread
// owns `VEC` adjacent columns (8-byte loads: float2 for f32, four bf16 for
// bf16; a row that is not 8-byte aligned takes narrower loads, down to one
// element) and, node by node, loads the messages of up to 8 listed edges
// into separate registers before adding them into one f32 accumulator in
// list order. A sum's order is therefore the edge order alone: it does not
// depend on B, on `block_n`, on `block_e` (a window's partial sums are
// carried in shared memory, not added as a second sum) or on the column
// split, so row b of a batched call is bitwise equal to that graph alone.
// Every output element is written once, zeros for a node with no edge.
// Edges with dst outside [0, n_nodes) (masked edges are routed to the
// n_nodes sentinel by the wrapper) match no node and are never loaded.
//
// Bound: memory. The valid messages are read once, dst once, the output
// written once: 4·(n_valid·F + B·E + B·n_nodes·F) bytes in f32 — ~58.6 MB,
// ~17 us at 3.35 TB/s at (B=8, E=2048, A=64, F=866), ~1.8 us for one graph.
// What stands in the way is latency: a graph of this size has ~30 edges a
// node, so each thread's work is a few dependent DRAM round trips, after a
// walk of the graph's dst that every CTA makes. The design keeps both
// short: no load of an edge outside the CTA's nodes (the compacted list);
// eight independent 8-byte loads in flight a thread before the first add;
// the walk's dst loads eight chunks deep a warp; and CTAs as wide as the
// columns allow, so more threads share each walk, while half the SMs stay
// busy (at B=1, one node and half the columns a CTA: 128 CTAs; the
// wrapper's `plan` lets nodes share a CTA when the grid is large).
#include "common.cuh"

constexpr int SS_UNROLL = 8;       // message loads in flight a thread
constexpr int SS_SCAN = 8;         // dst chunks of 32 in flight a warp
constexpr int SS_MAX_THREADS = 256;

template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

// Dynamic shared memory of one CTA, in 4-byte words. Kept equal to
// `smem_bytes` in kernels/segment_sum/ops.py.
__host__ __device__ inline size_t ss_smem_words(int block_n, int block_e,
                                                int threads, int carry) {
  return 2 * (size_t)block_e + (size_t)(threads / 32) * block_n + block_n +
         1 + (size_t)carry * block_n * threads;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(SS_MAX_THREADS)
segment_sum_kernel(const T* __restrict__ msg, const int32_t* __restrict__ dst,
                   T* __restrict__ out, int E, int F, int n_nodes,
                   int block_n, int block_e, int lanes) {
  extern __shared__ int smem[];
  const int nthreads = blockDim.x, nwarps = nthreads / 32;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int node0 = blockIdx.y * block_n;
  const int nb = min(block_n, n_nodes - node0);
  const int b = blockIdx.z;
  const int n_win = E > block_e ? (E + block_e - 1) / block_e : 1;

  int* win = smem;                          // [block_e] local node or -1
  unsigned* masks = reinterpret_cast<unsigned*>(smem);
                                            // (block_n == 1) chunk masks
  int* list = win + block_e;                // [block_e] edge ids by node
  int* cnt = list + block_e;                // [nwarps][block_n]
  int* start = cnt + nwarps * block_n;      // [block_n + 1] list offsets
  float* carry = reinterpret_cast<float*>(start + block_n + 1);
                                            // [block_n][VEC][nthreads]

  const int v = blockIdx.x * lanes + tid;   // this thread's vector lane
  const bool active = tid < lanes && v < F / VEC;
  const int col = v * VEC;
  const T* mcol = msg + (size_t)b * E * F + col;
  const int32_t* drow = dst + (size_t)b * E;
  const unsigned below = (1u << lane) - 1;

  for (int w = 0; w < n_win; ++w) {
    const int e0 = w * block_e;
    const int ne = max(0, min(block_e, E - e0));
    // each warp's contiguous, 32-aligned slice of the window
    const int per = ((ne + 31) / 32 + nwarps - 1) / nwarps * 32;
    const int lo = min(ne, warp * per), hi = min(ne, lo + per);
    int* mine = cnt + warp * nb;
    __syncthreads();                        // the previous window is used
    for (int r = lane; r < nb; r += 32) mine[r] = 0;
    __syncwarp();

    // pass 1: read the slice, SS_SCAN chunks of 32 dst in flight, and
    // count its matches. One node: a ballot a chunk, kept as the chunk's
    // mask. Several: the local node staged, __match_any_sync groups the
    // lanes by node and each group's first lane adds its size.
    int n = 0;
    for (int c0 = lo; c0 < hi; c0 += 32 * SS_SCAN) {
      int x[SS_SCAN];
#pragma unroll
      for (int j = 0; j < SS_SCAN; ++j) {
        const int i = c0 + 32 * j + lane;
        x[j] = i < hi ? drow[e0 + i] : -1;
      }
#pragma unroll
      for (int j = 0; j < SS_SCAN; ++j) {
        const int c = c0 + 32 * j;
        if (c >= hi) break;                 // warp-uniform
        const int d = (c + lane < hi && x[j] >= node0 && x[j] < node0 + nb)
                          ? x[j] - node0 : -1;
        if (nb == 1) {
          const unsigned m = __ballot_sync(0xffffffffu, d >= 0);
          if (lane == 0) masks[c / 32] = m;
          n += __popc(m);
        } else {
          if (c + lane < hi) win[c + lane] = d;
          const unsigned grp = __match_any_sync(0xffffffffu, d);
          if (d >= 0 && lane == __ffs(grp) - 1) mine[d] += __popc(grp);
          __syncwarp();
        }
      }
    }
    if (nb == 1 && lane == 0) mine[0] = n;
    __syncthreads();
    // cnt[w][r] -> the count of node r's edges in the warps before w; and
    // start[r] <- node r's total, then the exclusive scan over nodes
    for (int r = tid; r < nb; r += nthreads) {
      int t = 0;
      for (int q = 0; q < nwarps; ++q) {
        const int c = cnt[q * nb + r];
        cnt[q * nb + r] = t;
        t += c;
      }
      start[r] = t;
    }
    __syncthreads();
    if (warp == 0) {
      int run = 0;
      for (int r0 = 0; r0 < nb; r0 += 32) {
        const int x = r0 + lane < nb ? start[r0 + lane] : 0;
        int inc = x;
#pragma unroll
        for (int o = 1; o < 32; o *= 2) {
          const int y = __shfl_up_sync(0xffffffffu, inc, o);
          if (lane >= o) inc += y;
        }
        if (r0 + lane < nb) start[r0 + lane] = run + inc - x;
        run += __shfl_sync(0xffffffffu, inc, 31);
      }
      if (lane == 0) start[nb] = run;
    }
    __syncthreads();
    // pass 2: write each match at its place, in edge order
    if (nb == 1) {
      int run = start[0] + mine[0];
      for (int c = lo; c < hi; c += 32) {
        const unsigned m = masks[c / 32];
        if (m >> lane & 1u) list[run + __popc(m & below)] = e0 + c + lane;
        run += __popc(m);
      }
    } else {
      for (int c = lo; c < hi; c += 32) {
        const int d = c + lane < hi ? win[c + lane] : -1;
        const unsigned grp = __match_any_sync(0xffffffffu, d);
        if (d >= 0) list[start[d] + mine[d] + __popc(grp & below)] =
            e0 + c + lane;
        __syncwarp();
        if (d >= 0 && lane == __ffs(grp) - 1) mine[d] += __popc(grp);
        __syncwarp();
      }
    }
    __syncthreads();
    if (!active) continue;

    const bool last = w == n_win - 1;
    for (int r = 0; r < nb; ++r) {
      float acc[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        acc[k] = w == 0 ? 0.f : carry[(r * VEC + k) * nthreads + tid];
      const int s = start[r], t = start[r + 1];
      for (int i = s; i < t; i += SS_UNROLL) {
        Vec<T, VEC> m[SS_UNROLL];
#pragma unroll
        for (int u = 0; u < SS_UNROLL; ++u)
          if (i + u < t)
            m[u] = *reinterpret_cast<const Vec<T, VEC>*>(
                mcol + (size_t)list[i + u] * F);
#pragma unroll
        for (int u = 0; u < SS_UNROLL; ++u)
          if (i + u < t) {
#pragma unroll
            for (int k = 0; k < VEC; ++k) acc[k] += to_f32(m[u].v[k]);
          }
      }
      if (last) {
        Vec<T, VEC> o;
#pragma unroll
        for (int k = 0; k < VEC; ++k) o.v[k] = from_f32<T>(acc[k]);
        *reinterpret_cast<Vec<T, VEC>*>(
            out + ((size_t)b * n_nodes + node0 + r) * F + col) = o;
      } else {
#pragma unroll
        for (int k = 0; k < VEC; ++k)
          carry[(r * VEC + k) * nthreads + tid] = acc[k];
      }
    }
  }
}

template <typename T, int VEC>
static int launch(const void* msg, const int32_t* dst, void* out, int B,
                  int E, int F, int n_nodes, int block_n, int block_e,
                  int lanes, int chunks, cudaStream_t stream) {
  const int threads = (lanes + 31) / 32 * 32;
  if (threads > SS_MAX_THREADS || F % VEC) return (int)cudaErrorInvalidValue;
  const int carry = E > block_e ? VEC : 0;
  const size_t smem = 4 * ss_smem_words(block_n, block_e, threads, carry);
  cudaError_t err = allow_smem(segment_sum_kernel<T, VEC>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(chunks, (n_nodes + block_n - 1) / block_n, B);
  segment_sum_kernel<T, VEC><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(msg), dst, static_cast<T*>(out), E, F, n_nodes,
      block_n, block_e, lanes);
  return (int)cudaGetLastError();
}

// msg (B,E,F) and out (B,n_nodes,F) contiguous, dtype 0 = f32, 1 = bf16;
// dst (B,E) int32, any value outside [0, n_nodes) contributing nothing.
// `vec` columns a thread (f32: 1 or 2; bf16: 1, 2 or 4; F a multiple of it
// and the rows aligned to it), `lanes` vector lanes a CTA, `chunks` CTAs
// across the columns.
extern "C" int segment_sum_launch(const void* msg, const int32_t* dst,
                                  void* out, int B, int E, int F, int n_nodes,
                                  int block_n, int block_e, int lanes,
                                  int chunks, int vec, int dtype,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && vec == 2)
    return launch<float, 2>(msg, dst, out, B, E, F, n_nodes, block_n,
                            block_e, lanes, chunks, s);
  if (dtype == 0 && vec == 1)
    return launch<float, 1>(msg, dst, out, B, E, F, n_nodes, block_n,
                            block_e, lanes, chunks, s);
  if (dtype == 1 && vec == 4)
    return launch<__nv_bfloat16, 4>(msg, dst, out, B, E, F, n_nodes,
                                    block_n, block_e, lanes, chunks, s);
  if (dtype == 1 && vec == 2)
    return launch<__nv_bfloat16, 2>(msg, dst, out, B, E, F, n_nodes,
                                    block_n, block_e, lanes, chunks, s);
  if (dtype == 1 && vec == 1)
    return launch<__nv_bfloat16, 1>(msg, dst, out, B, E, F, n_nodes,
                                    block_n, block_e, lanes, chunks, s);
  return (int)cudaErrorInvalidValue;
}
