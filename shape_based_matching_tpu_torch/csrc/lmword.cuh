// Word-wide reads of a linear-memory buffer (lmflat), shared by coarse.cu
// and chain.cu: a thread owns 4 consecutive cells and reads the bytes at
// a + 0 .. a + 3 for any alignment of a.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace sbm {

constexpr int WORD_CELLS = 4;  // consecutive cells per thread

// Bytes a .. a+3 as one little-endian word, from the two aligned words
// that cover them. An aligned word that holds a byte of the tensor lies in
// its allocation; bytes of it outside the 4 cells are shifted out.
__device__ __forceinline__ uint32_t load4(const uint8_t* a) {
  const uintptr_t u = reinterpret_cast<uintptr_t>(a);
  const uint32_t* w = reinterpret_cast<const uint32_t*>(u & ~uintptr_t{3});
  return __funnelshift_r(__ldg(w), __ldg(w + 1),
                         static_cast<uint32_t>(u & 3) * 8);
}

// The same bytes one at a time, the first `live` only (zero elsewhere).
__device__ __forceinline__ uint32_t load4_edge(const uint8_t* a, int live) {
  uint32_t v = 0;
#pragma unroll
  for (int u = 0; u < WORD_CELLS; ++u)
    if (u < live) v |= static_cast<uint32_t>(__ldg(a + u)) << (8 * u);
  return v;
}

// acc[u] += byte u of pk
__device__ __forceinline__ void widen(uint32_t pk, int* acc) {
  acc[0] += pk & 0xFFu;
  acc[1] += (pk >> 8) & 0xFFu;
  acc[2] += (pk >> 16) & 0xFFu;
  acc[3] += pk >> 24;
}

}  // namespace sbm
