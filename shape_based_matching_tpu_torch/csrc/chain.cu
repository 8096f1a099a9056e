// Delta-chain coarse scoring with per-template threshold counts:
//   S[b, k, j] = S[b, k-1, j] + sum_{added s} lmflat[b, off_s + j]
//                             - sum_{removed s} lmflat[b, off_s + j]
//   (a program's first template starts from 0 and adds all its slots)
//   cnt[b, k] += #{ j : j < pos[k] and S[b, k, j] >= rmin[k] }
// for every cell j < M, which is bit for bit sum_n lmflat[b, off[k, n] + j]
// (integer sums are exact in any order).
//
// Replaces the TPU kernel shape_based_matching_tpu/ops/pallas/
// similarity_pallas.py::_make_chain_kernel as run by
// _chain_word_rows_counted; its uncounted form (_chain_word_rows) serves
// only the JAX package's cells route and escape hatches, which the port
// does not have, so the count is always on. Plain twin:
// ops/cuda/chain.py::chain_scores_plain. Plan: ops/chain_plan.py;
// segments: ops/cuda/chain.py::segment_plan.
//
// Rows are indexed by template, so the output is exactly coarse.cu's
// (S [B, K, M], cnt [B, K]).
//
// What bounds it on this card: the K*M*4-byte store of S (164 MB at
// 10,000 templates of a dense bank at a 512^2 coarse level, 0.05 ms at
// 3.35 TB/s); the slot reads (about 2.5e4 slot visits x 4096 cells there)
// come from L2, where one frame's lmflat (2 MB) stays. The first design
// gave each block one whole program and put a barrier after every
// template: the block with the 126-template program set the time (0.25
// ms), its 8 warps waiting on each other at every row.
// Design:
// * Segments. The wrapper cuts each program into segments of at most Z
//   templates (a pure function of the plan's shapes) and orders them
//   longest first; a block owns one (segment, 1024-cell tile, frame), the
//   tile fastest, so the longest walks start first. A segment that does
//   not begin at its program's base first builds its start row -- the
//   scores of the template before it -- from start codes: the net
//   multiset of its program's slots before it, which is that template's
//   own feature offsets (at most 32 at the coarse level of the dense
//   bank, where the signed slots before it run up to 256).
// * No barrier per template. The block stages its start codes and its
//   own slots in shared memory (one chunk on the path's plans, where a
//   program has at most 256 slots); after each template every warp counts
//   its cells with one __reduce_add_sync and one integer atomicAdd, exact
//   in any order.
// * Word-wide I/O. A thread owns 4 consecutive cells, reads one 32-bit
//   word per slot (lmword.cuh: funnel-shifted from two aligned words, byte
//   by byte where a word could pass the tensor's end), sums added and
//   removed words in two packed byte-lane accumulators (responses are at
//   most 4, so 63 slots fit a lane), and stores each row as one 16-byte
//   store where the row is 16-byte aligned (scalar for odd M).

#include <cstdint>
#include <cuda_runtime.h>

#include "lmword.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int CELLS = 4;                 // consecutive cells per thread
constexpr int TILE = THREADS * CELLS;    // cells per block
constexpr int LANE_SLOTS = 63;           // slots per packed-lane run
constexpr int STAGE = 2048;              // codes staged in shared memory

using sbm::load4;
using sbm::load4_edge;

// acc[u] += sum over codes[0 .. n) of the signed byte u at lm + off + j0:
// a code is off (added) or ~off (removed).
__device__ __forceinline__ void add_codes(const uint8_t* lm,
                                          const int* codes, int n, int j0,
                                          int live, bool safe, int* acc) {
  for (int r0 = 0; r0 < n; r0 += LANE_SLOTS) {
    const int r1 = min(n, r0 + LANE_SLOTS);
    uint32_t pa = 0, ps = 0;  // packed sums of added / removed words
    if (safe) {
#pragma unroll 8
      for (int i = r0; i < r1; ++i) {
        const int code = codes[i];
        const uint32_t neg = static_cast<uint32_t>(code >> 31);
        const uint32_t w = load4(lm + (code ^ static_cast<int>(neg)) + j0);
        pa += w & ~neg;
        ps += w & neg;
      }
    } else {
      for (int i = r0; i < r1; ++i) {
        const int code = codes[i];
        const uint32_t neg = static_cast<uint32_t>(code >> 31);
        const uint32_t w =
            load4_edge(lm + (code ^ static_cast<int>(neg)) + j0, live);
        pa += w & ~neg;
        ps += w & neg;
      }
    }
#pragma unroll
    for (int u = 0; u < CELLS; ++u)
      acc[u] += static_cast<int>((pa >> (8 * u)) & 0xFFu) -
                static_cast<int>((ps >> (8 * u)) & 0xFFu);
  }
}

// Stage src[c0 .. c1) into s_code; every thread of the block calls it.
__device__ __forceinline__ void stage(int* s_code, const int* src, int c0,
                                     int c1) {
  __syncthreads();
  for (int i = threadIdx.x; i < c1 - c0; i += THREADS)
    s_code[i] = src[c0 + i];
  __syncthreads();
}

// grid (tiles * B * NSEG); block x = (seg * B + b) * tiles + tile.
// seg = (k0, k1, pre_begin, pre_end): templates [k0, k1), start codes
// pre[pre_begin .. pre_end) (codes as slots are: off or ~off).
__global__ void __launch_bounds__(THREADS)
chain_kernel(const uint8_t* __restrict__ lmflat, long long lm_stride,
             const int* __restrict__ slot_start,
             const int* __restrict__ slots, const int4* __restrict__ segs,
             const int* __restrict__ pre, const int* __restrict__ pos,
             const int* __restrict__ rmin, int* __restrict__ S,
             int* __restrict__ cnt, int B, int K, int M, int tiles) {
  __shared__ int s_code[STAGE];
  const int tile = blockIdx.x % tiles;
  const int rest = blockIdx.x / tiles;
  const int b = rest % B;
  const int4 sg = segs[rest / B];
  const uint8_t* lm = lmflat + b * lm_stride;
  const int j0 = tile * TILE + threadIdx.x * CELLS;
  // every word this thread reads ends at or below lm + L + j0 + 7, with
  // L = lm_stride - M the largest offset; the tensor ends B - b frames on
  const bool safe = (lm_stride - M) + j0 + 7 < (B - b) * lm_stride;
  const int live = min(CELLS, M - j0);  // cells of this thread below M

  int acc[CELLS] = {0, 0, 0, 0};
  for (int c0 = sg.z; c0 < sg.w; c0 += STAGE) {  // the start row
    const int c1 = min(c0 + STAGE, sg.w);
    stage(s_code, pre, c0, c1);
    if (live > 0) add_codes(lm, s_code, c1 - c0, j0, live, safe, acc);
  }

  const int s_end = slot_start[sg.y];
  int s = slot_start[sg.x];
  int c0 = s, c1 = s;  // slots [c0, c1) are staged
  const bool vec = live == CELLS && (M & 3) == 0;
  for (int k = sg.x; k < sg.y; ++k) {
    const int e = __ldg(slot_start + k + 1);
    while (s < e) {  // uniform over the block
      if (s >= c1) {
        c0 = s;
        c1 = min(s + STAGE, s_end);
        stage(s_code, slots, c0, c1);
      }
      const int n = min(e, c1) - s;
      if (live > 0) add_codes(lm, s_code + (s - c0), n, j0, live, safe, acc);
      s += n;
    }

    int* row = S + (static_cast<size_t>(b) * K + k) * M;
    const int p_k = __ldg(pos + k);
    const int r_k = __ldg(rmin + k);
    int c = 0;
    if (vec) {
      *reinterpret_cast<int4*>(row + j0) =
          make_int4(acc[0], acc[1], acc[2], acc[3]);
    } else {
#pragma unroll
      for (int u = 0; u < CELLS; ++u)
        if (u < live) row[j0 + u] = acc[u];
    }
#pragma unroll
    for (int u = 0; u < CELLS; ++u)
      c += (u < live) && (j0 + u < p_k) && (acc[u] >= r_k);
    c = __reduce_add_sync(0xffffffffu, c);
    if ((threadIdx.x & 31) == 0 && c)
      atomicAdd(cnt + static_cast<size_t>(b) * K + k, c);
  }
}

}  // namespace

// cnt must be zeroed by the caller.
extern "C" int sbm_chain_scores(const void* lmflat, long long lm_stride,
                                const void* slot_start, const void* slots,
                                const void* segs, const void* pre,
                                const void* pos, const void* rmin, void* S,
                                void* cnt, int B, int NSEG, int K, int M,
                                void* stream) {
  const int tiles = (M + TILE - 1) / TILE;
  const long long blocks = static_cast<long long>(tiles) * B * NSEG;
  if (blocks > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  chain_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(lmflat), lm_stride,
      static_cast<const int*>(slot_start), static_cast<const int*>(slots),
      static_cast<const int4*>(segs), static_cast<const int*>(pre),
      static_cast<const int*>(pos), static_cast<const int*>(rmin),
      static_cast<int*>(S), static_cast<int*>(cnt), B, K, M, tiles);
  return static_cast<int>(cudaGetLastError());
}
