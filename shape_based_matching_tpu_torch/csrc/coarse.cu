// Coarse template scoring with per-template threshold counts:
//   S[b, k, j] = sum_n lmflat[b, off[k, n] + j]          for j < M
//   cnt[b, k] += #{ j : j < pos[k] and S[b, k, j] >= rmin[k] }
// With cnt null the count is off (pos and rmin are not read): S alone is
// the unmasked score map of every template, as the refine level's map
// route needs it.
//
// Replaces the TPU kernel shape_based_matching_tpu/ops/pallas/
// similarity_pallas.py::_make_rotate_kernel as run by _run_rotate_kernel:
// counted from _coarse_words_pallas_counted (the packed4 route), and
// uncounted from _coarse_words_pallas and _coarse_similarity_pallas (full
// maps, mask_positions=False); and the wide kernel _make_wide_kernel as
// run by _coarse_words_wide_counted (banks of 64 to 16383 slots): the
// function is the same S and cnt, and the int32 sums have no width limit.
// Plain twins: ops/cuda/coarse.py::coarse_scores_plain and
// coarse_maps_plain.
//
// A feature's shift is an address add into the one contiguous lmflat
// buffer (linear memories plus an M-byte zero tail), so the reference's
// flat semantics come for free: the row wrap, the read into the next
// plane's head, and invalid/off-image features (offset L) reading zeros.
//
// What bounds it on this card: the K*N*M byte reads of lmflat, served
// from L2 (one frame's lmflat, 2-17 MB, fits the 50 MB L2): at D=1024 x
// 63 slots x 65536 cells, 4.2 GB in about 0.6 ms, near L2's rate. A
// variant with 16 cells a thread, 16-byte vector loads and shuffles
// (half the L1 requests, 80 registers) took 0.92 ms there, so the L2
// reads, not the L1 requests, set the time: the next step is reuse
// between templates that share offsets. The store of S (K*M*4 bytes)
// bounds the flagship's 1000 x 32 slots. The first design read one byte
// per load and gave each thread all N slots;
// at 8 templates x 3073 slots its grid was 32 blocks on 132 SMs, each
// thread walking the slots one after another (0.21% of the bound), and
// at D=1024 x 63 slots x 65536 cells it issued 4.2e9 byte loads.
// Design:
// * Word-wide loads. A thread owns 4 consecutive cells j0..j0+3. For each
//   slot it reads the two aligned 32-bit words that cover
//   off + j0 .. off + j0 + 3 and lines the bytes up with __funnelshift_r,
//   so offsets (and lm_stride, and a sliced frame's data_ptr) may have any
//   alignment. An aligned word that holds a byte of the tensor lies in
//   its allocation; bytes of it outside the 4 cells are shifted out.
// * Packed lanes. The 4 bytes are summed in one 32-bit add: lmflat bytes
//   are responses, at most 4 (ops/response.py), so a lane holds 63 slots
//   (252) without a carry, and the lanes are widened into int32 every
//   LANE_SLOTS slots. Lanes of cells j >= M (the thread past the end of a
//   row) may hold anything; a carry only runs upward into other such
//   lanes, and they are never stored.
// * Frame ends. A thread whose highest word could pass the tensor's last
//   byte (the last frame's last cells) reads byte by byte, cells j < M
//   only, so no load leaves the tensor's allocation.
// * Slot groups. When B*K*ceil(M/1024) blocks would not fill the card
//   (8 templates x 4 tiles), the wrapper (ops/cuda/coarse.py::
//   coarse_split) splits the slots into G groups of `chunk` across blocks.
//   Partial sums meet by integer atomicAdd into an S the wrapper zeroed
//   (exact in any order), and the count, which needs the whole sum, runs
//   as a second pass over S. With G == 1 (the flagship, the level maps)
//   the count stays fused and S is stored once, 16 bytes a thread.
// * The block stages its template's offsets in shared memory and unrolls
//   the slot loop by 8, so each thread keeps 16 words in flight.

#include <cstdint>
#include <cuda_runtime.h>

#include "lmword.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int CELLS = 4;                   // consecutive cells per thread
constexpr int TILE = THREADS * CELLS;      // cells per block
constexpr int LANE_SLOTS = 63;             // slots per packed-lane run
constexpr int OFF_CHUNK = 16 * LANE_SLOTS; // offsets staged at a time

using sbm::load4;
using sbm::load4_edge;
using sbm::widen;

// Block sum of c, added to *dst by thread 0 (skipped when zero).
__device__ __forceinline__ void block_count(int c, int* s_warp, int* dst) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) c += __shfl_down_sync(0xffffffffu, c, o);
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) total += s_warp[w];
    if (total) atomicAdd(dst, total);
  }
}

__device__ __forceinline__ int count_cells(const int* acc, int j0, int M,
                                           int p_k, int r_k) {
  int c = 0;
#pragma unroll
  for (int u = 0; u < CELLS; ++u) {
    const int j = j0 + u;
    c += (j < M) && (j < p_k) && (acc[u] >= r_k);
  }
  return c;
}

// grid (K, tiles * G, B); block y = tile * G + g sums slots
// [g * chunk, min(N, (g + 1) * chunk)) of template k over the tile's
// cells.
__global__ void __launch_bounds__(THREADS)
coarse_kernel(const uint8_t* __restrict__ lmflat, long long lm_stride,
              const int* __restrict__ off, const int* __restrict__ pos,
              const int* __restrict__ rmin, int* __restrict__ S,
              int* __restrict__ cnt, int K, int N, int M, int G,
              int chunk) {
  __shared__ int s_off[OFF_CHUNK];
  __shared__ int s_warp[THREADS / 32];
  const int k = blockIdx.x;
  const int b = blockIdx.z;
  const int tile = blockIdx.y / G;
  const int g = blockIdx.y - tile * G;
  const uint8_t* lm = lmflat + b * lm_stride;
  const int j0 = tile * TILE + threadIdx.x * CELLS;
  const int n_begin = g * chunk;
  const int n_end = min(N, n_begin + chunk);
  // every word this thread reads ends at or below lm + L + j0 + 7, with
  // L = lm_stride - M the largest offset; the tensor ends B - b frames on
  const bool safe =
      (lm_stride - M) + j0 + 7 < (gridDim.z - b) * lm_stride;
  const int live = min(CELLS, M - j0);  // cells of this thread below M

  int acc[CELLS] = {0, 0, 0, 0};
  for (int c0 = n_begin; c0 < n_end; c0 += OFF_CHUNK) {
    const int nc = min(OFF_CHUNK, n_end - c0);
    __syncthreads();
    for (int i = threadIdx.x; i < nc; i += THREADS)
      s_off[i] = off[static_cast<size_t>(k) * N + c0 + i];
    __syncthreads();
    if (live <= 0) continue;
    for (int r0 = 0; r0 < nc; r0 += LANE_SLOTS) {
      const int r1 = min(nc, r0 + LANE_SLOTS);
      uint32_t pk = 0;
      if (safe) {
#pragma unroll 8
        for (int n = r0; n < r1; ++n) pk += load4(lm + s_off[n] + j0);
      } else {
        for (int n = r0; n < r1; ++n)
          pk += load4_edge(lm + s_off[n] + j0, live);
      }
      widen(pk, acc);
    }
  }

  int* row = S + (static_cast<size_t>(b) * K + k) * M;
  if (G > 1) {  // partial sums; the count runs over S afterwards
#pragma unroll
    for (int u = 0; u < CELLS; ++u)
      if (u < live && acc[u]) atomicAdd(row + j0 + u, acc[u]);
    return;
  }
  if (live == CELLS &&
      (reinterpret_cast<uintptr_t>(row + j0) & 15) == 0) {
    *reinterpret_cast<int4*>(row + j0) =
        make_int4(acc[0], acc[1], acc[2], acc[3]);
  } else {
#pragma unroll
    for (int u = 0; u < CELLS; ++u)
      if (u < live) row[j0 + u] = acc[u];
  }
  if (cnt == nullptr) return;  // uniform over the grid
  block_count(count_cells(acc, j0, M, pos[k], rmin[k]), s_warp,
              cnt + static_cast<size_t>(b) * K + k);
}

// The count of a split launch: grid (tiles, K, B) over the summed S.
__global__ void __launch_bounds__(THREADS)
count_kernel(const int* __restrict__ S, const int* __restrict__ pos,
             const int* __restrict__ rmin, int* __restrict__ cnt, int K,
             int M) {
  __shared__ int s_warp[THREADS / 32];
  const int k = blockIdx.y;
  const int b = blockIdx.z;
  const int j0 = blockIdx.x * TILE + threadIdx.x * CELLS;
  const int* row = S + (static_cast<size_t>(b) * K + k) * M;
  int acc[CELLS];
#pragma unroll
  for (int u = 0; u < CELLS; ++u) acc[u] = j0 + u < M ? row[j0 + u] : 0;
  block_count(count_cells(acc, j0, M, pos[k], rmin[k]), s_warp,
              cnt + static_cast<size_t>(b) * K + k);
}

}  // namespace

// G > 1 needs S zeroed by the caller; cnt (when not null) always does.
extern "C" int sbm_coarse_scores(const void* lmflat, long long lm_stride,
                                 const void* off, const void* pos,
                                 const void* rmin, void* S, void* cnt, int B,
                                 int K, int N, int M, int G, int chunk,
                                 void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = (M + TILE - 1) / TILE;
  coarse_kernel<<<dim3(K, tiles * G, B), THREADS, 0, st>>>(
      static_cast<const uint8_t*>(lmflat), lm_stride,
      static_cast<const int*>(off), static_cast<const int*>(pos),
      static_cast<const int*>(rmin), static_cast<int*>(S),
      static_cast<int*>(cnt), K, N, M, G, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || G == 1 || cnt == nullptr)
    return static_cast<int>(err);
  count_kernel<<<dim3(tiles, K, B), THREADS, 0, st>>>(
      static_cast<const int*>(S), static_cast<const int*>(pos),
      static_cast<const int*>(rmin), static_cast<int*>(cnt), K, M);
  return static_cast<int>(cudaGetLastError());
}
