// First-max argmax over a 256-thread block, one value per thread: the
// largest value wins, ties go to the lower index (a strict > scan, as the
// reference's). Used by refine.cu.

#pragma once

#include <cuda_runtime.h>

namespace sbm {

constexpr int ARGMAX_THREADS = 256;

// Every thread of the block calls this; thread 0 gets the block's (value,
// index) in *v and *i. s_val and s_idx hold ARGMAX_THREADS / 32 entries.
__device__ __forceinline__ void block_argmax(int* v, int* i, int* s_val,
                                             int* s_idx) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const int ov = __shfl_down_sync(0xffffffffu, *v, o);
    const int oi = __shfl_down_sync(0xffffffffu, *i, o);
    if (ov > *v || (ov == *v && oi < *i)) {
      *v = ov;
      *i = oi;
    }
  }
  const int tid = threadIdx.x;
  if ((tid & 31) == 0) {
    s_val[tid >> 5] = *v;
    s_idx[tid >> 5] = *i;
  }
  __syncthreads();
  if (tid == 0) {
    *v = s_val[0];
    *i = s_idx[0];
#pragma unroll
    for (int w = 1; w < ARGMAX_THREADS / 32; ++w) {
      if (s_val[w] > *v || (s_val[w] == *v && s_idx[w] < *i)) {
        *v = s_val[w];
        *i = s_idx[w];
      }
    }
  }
}

}  // namespace sbm
