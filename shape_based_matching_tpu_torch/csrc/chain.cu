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
// ops/cuda/chain.py::chain_scores_plain. Plan: ops/chain_plan.py.
//
// Rows are indexed by template, so the output is exactly coarse.cu's
// (S [B, K, M], cnt [B, K]); the TPU kernel's output rows per program and
// their emit map do not exist here.
//
// Bound on the card: the slot loads (about 2.5e4 slots x 4096 cells at
// 10,000 templates of a dense bank at a 512^2 coarse level, against
// 3.2e5 x 4096 from scratch) and the K*M*4-byte store of S (164 MB there,
// 0.05 ms at full bandwidth), which the chain does not shrink; in practice
// the latency of each block's serial walk over its ~43 templates.
//
// Design: a block owns one program (one chain), one 1024-cell tile and
// one frame; each thread keeps 4 cells 256 apart in registers as
// coarse.cu does, so every load and store of a warp touches consecutive
// addresses. The program's slot codes are staged in
// shared memory in chunks. A slot code is off (added) or ~off (removed);
// its sign bit selects the sign without a branch. After each template
// the block stores its row and counts it with a warp reduction and one
// integer atomicAdd, exact in any order; the warp partials alternate
// between two shared buffers, so one barrier per template suffices.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int CELLS = 4;  // cells per thread
constexpr int SLOT_CHUNK = 2048;

__global__ void __launch_bounds__(THREADS)
chain_kernel(const uint8_t* __restrict__ lmflat, long long lm_stride,
             const int* __restrict__ prog_start,
             const int* __restrict__ slot_start,
             const int* __restrict__ slots, const int* __restrict__ pos,
             const int* __restrict__ rmin, int* __restrict__ S,
             int* __restrict__ cnt, int K, int M) {
  __shared__ int s_slot[SLOT_CHUNK];
  __shared__ int s_warp[2][THREADS / 32];
  const int b = blockIdx.z;
  const uint8_t* lm = lmflat + b * lm_stride;
  const int j0 = blockIdx.y * (THREADS * CELLS) + threadIdx.x;
  const int k0 = prog_start[blockIdx.x];
  const int k1 = prog_start[blockIdx.x + 1];
  const int s_end = slot_start[k1];
  int c0 = slot_start[k0];  // slots [c0, c1) are staged in s_slot
  int c1 = c0;

  int acc[CELLS];
#pragma unroll
  for (int u = 0; u < CELLS; ++u) acc[u] = 0;

  for (int k = k0; k < k1; ++k) {
    const int e = slot_start[k + 1];
    for (int s = slot_start[k]; s < e; ++s) {
      if (s >= c1) {
        __syncthreads();
        c0 = s;
        c1 = min(s + SLOT_CHUNK, s_end);
        for (int i = threadIdx.x; i < c1 - c0; i += THREADS)
          s_slot[i] = slots[c0 + i];
        __syncthreads();
      }
      const int code = s_slot[s - c0];
      const int neg = code >> 31;  // 0 (added) or -1 (removed)
      const uint8_t* p = lm + (code ^ neg);
#pragma unroll
      for (int u = 0; u < CELLS; ++u) {
        const int j = j0 + u * THREADS;
        if (j < M) acc[u] += (static_cast<int>(__ldg(p + j)) ^ neg) - neg;
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
    int* part = s_warp[k & 1];
    if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = c;
    __syncthreads();
    if (threadIdx.x == 0) {
      int total = 0;
#pragma unroll
      for (int w = 0; w < THREADS / 32; ++w) total += part[w];
      if (total) atomicAdd(cnt + static_cast<size_t>(b) * K + k, total);
    }
  }
}

}  // namespace

extern "C" int sbm_chain_scores(const void* lmflat, long long lm_stride,
                                const void* prog_start,
                                const void* slot_start, const void* slots,
                                const void* pos, const void* rmin, void* S,
                                void* cnt, int B, int P, int K, int M,
                                void* stream) {
  const dim3 grid(P, (M + THREADS * CELLS - 1) / (THREADS * CELLS), B);
  chain_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(lmflat), lm_stride,
      static_cast<const int*>(prog_start),
      static_cast<const int*>(slot_start), static_cast<const int*>(slots),
      static_cast<const int*>(pos), static_cast<const int*>(rmin),
      static_cast<int*>(S), static_cast<int*>(cnt), K, M);
  return static_cast<int>(cudaGetLastError());
}
