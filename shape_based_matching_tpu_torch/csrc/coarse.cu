// Coarse template scoring with per-template threshold counts:
//   S[b, k, j] = sum_n lmflat[b, off[k, n] + j]          for j < M
//   cnt[b, k] += #{ j : j < pos[k] and S[b, k, j] >= rmin[k] }
//
// Replaces the TPU kernel shape_based_matching_tpu/ops/pallas/
// similarity_pallas.py::_make_rotate_kernel(counted=...) as run by
// _run_rotate_kernel from _coarse_words_pallas_counted (the packed4
// route). Plain twin: ops/cuda/coarse.py::coarse_scores_plain.
//
// A feature's shift is an address add into the one contiguous lmflat
// buffer (linear memories plus an M-byte zero tail), so the reference's
// flat semantics come for free: the row wrap, the read into the next
// plane's head, and invalid/off-image features (offset L) reading zeros.
// There is no byte packing and no feature-count limit: each thread sums
// bytes in an int32 register.
//
// Bound on the card: K*N*M byte loads (about 5e8 at 1000 templates x 32
// slots on a 128x128 coarse grid) served mostly from L1/L2, since one
// frame's lmflat (8 MB at T=8 for 1024^2) fits the 50 MB L2. Design: a
// block owns one template and 1024 consecutive cells, stages the
// template's offsets in shared memory, and each thread keeps 4 cells
// 256 apart so every load instruction of a warp reads 32 consecutive
// bytes. The count is reduced in the block and added with one integer
// atomicAdd, exact in any order.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int CELLS = 4;  // cells per thread
constexpr int OFF_CHUNK = 1024;

__global__ void __launch_bounds__(THREADS)
coarse_kernel(const uint8_t* __restrict__ lmflat, long long lm_stride,
              const int* __restrict__ off, const int* __restrict__ pos,
              const int* __restrict__ rmin, int* __restrict__ S,
              int* __restrict__ cnt, int K, int N, int M) {
  __shared__ int s_off[OFF_CHUNK];
  __shared__ int s_warp[THREADS / 32];
  const int k = blockIdx.x;
  const int b = blockIdx.z;
  const uint8_t* lm = lmflat + b * lm_stride;
  const int j0 = blockIdx.y * (THREADS * CELLS) + threadIdx.x;

  int acc[CELLS];
#pragma unroll
  for (int u = 0; u < CELLS; ++u) acc[u] = 0;

  for (int n0 = 0; n0 < N; n0 += OFF_CHUNK) {
    const int nc = min(OFF_CHUNK, N - n0);
    __syncthreads();
    for (int i = threadIdx.x; i < nc; i += THREADS)
      s_off[i] = off[static_cast<size_t>(k) * N + n0 + i];
    __syncthreads();
    for (int n = 0; n < nc; ++n) {
      const uint8_t* p = lm + s_off[n];
#pragma unroll
      for (int u = 0; u < CELLS; ++u) {
        const int j = j0 + u * THREADS;
        if (j < M) acc[u] += __ldg(p + j);
      }
    }
  }

  const int p_k = pos[k];
  const int r_k = rmin[k];
  int* row = S + (static_cast<size_t>(b) * K + k) * M;
  int c = 0;
#pragma unroll
  for (int u = 0; u < CELLS; ++u) {
    const int j = j0 + u * THREADS;
    if (j < M) {
      row[j] = acc[u];
      c += (j < p_k) && (acc[u] >= r_k);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) c += __shfl_down_sync(0xffffffffu, c, o);
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) total += s_warp[w];
    if (total) atomicAdd(cnt + static_cast<size_t>(b) * K + k, total);
  }
}

}  // namespace

extern "C" int sbm_coarse_scores(const void* lmflat, long long lm_stride,
                                 const void* off, const void* pos,
                                 const void* rmin, void* S, void* cnt, int B,
                                 int K, int N, int M, void* stream) {
  const dim3 grid(K, (M + THREADS * CELLS - 1) / (THREADS * CELLS), B);
  coarse_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(lmflat), lm_stride,
      static_cast<const int*>(off), static_cast<const int*>(pos),
      static_cast<const int*>(rmin), static_cast<int*>(S),
      static_cast<int*>(cnt), K, N, M);
  return static_cast<int>(cudaGetLastError());
}
