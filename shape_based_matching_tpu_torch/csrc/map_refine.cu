// Map-window candidate refinement: one 16x16 window per candidate out of
// the level's unmasked score maps of the distinct candidate templates,
// with the first-max argmax:
//   patch[rr, cc] = Sfull[b, min(slot*M + (wy+rr)*W + wx+cc, D*M - 1)]
// the flat read with the row wrap, clipped to the frame's D*M maps as the
// plain refine_from_maps clips its gather (similarity.py:1087-1091 of the
// JAX package). Candidates with live == 0 or slot < 0 do no work and
// report best = raw = 0.
//
// Replaces the TPU kernel shape_based_matching_tpu/ops/pallas/
// refine_pallas.py::_map_window_kernel (entry _refine_from_maps_pallas)
// plus the argmax half of its XLA epilogue. Plain twin:
// ops/cuda/map_refine.py::map_refine_plain. The TPU kernel's VMEM gate
// (the maps must fit on-chip memory, D <= 80 at 1024^2) has no
// counterpart: the maps stay in device memory and each block reads its
// own 16 rows of 64 bytes.
//
// Bound on the card: 256 int32 loads per candidate (1 MB at 4096
// candidates), against the D*M*4-byte maps written before it (268 MB at
// D=1024 on a 256x256 grid); launch latency sets its time. Design: one
// block of 256 threads per candidate, thread (rr, cc) loads one cell, the
// block argmax of refine.cu (argmax.cuh).

#include <cstdint>
#include <cuda_runtime.h>

#include "argmax.cuh"

namespace {

constexpr int THREADS = sbm::ARGMAX_THREADS;  // one per window cell

__global__ void __launch_bounds__(THREADS)
map_refine_kernel(const int* __restrict__ Sfull, long long frame_len,
                  int M, int W, const int* __restrict__ slot,
                  const int* __restrict__ wx, const int* __restrict__ wy,
                  const uint8_t* __restrict__ live,
                  int* __restrict__ best_out, int* __restrict__ raw_out,
                  int C) {
  __shared__ int s_val[THREADS / 32];
  __shared__ int s_idx[THREADS / 32];
  const int ci = blockIdx.y * C + blockIdx.x;
  const int tid = threadIdx.x;
  const int sl = slot[ci];
  if (!live[ci] || sl < 0) {
    if (tid == 0) {
      best_out[ci] = 0;
      raw_out[ci] = 0;
    }
    return;
  }
  long long idx = static_cast<long long>(sl) * M +
                  static_cast<long long>(wy[ci] + (tid >> 4)) * W + wx[ci] +
                  (tid & 15);
  idx = min(max(idx, 0LL), frame_len - 1);
  int v = __ldg(Sfull + blockIdx.y * frame_len + idx);
  int i = tid;
  sbm::block_argmax(&v, &i, s_val, s_idx);
  if (tid == 0) {
    best_out[ci] = i;
    raw_out[ci] = v;
  }
}

}  // namespace

extern "C" int sbm_map_refine(const void* Sfull, int D, int M, int W,
                              const void* slot, const void* wx,
                              const void* wy, const void* live, void* best,
                              void* raw, int B, int C, void* stream) {
  const dim3 grid(C, B);
  map_refine_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(Sfull), static_cast<long long>(D) * M, M, W,
      static_cast<const int*>(slot), static_cast<const int*>(wx),
      static_cast<const int*>(wy), static_cast<const uint8_t*>(live),
      static_cast<int*>(best), static_cast<int*>(raw), C);
  return static_cast<int>(cudaGetLastError());
}
