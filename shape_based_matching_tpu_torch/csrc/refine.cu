// Windowed candidate refinement (16x16 local similarity) straight from
// the linear memories, with the first-max argmax:
//   patch[rr, cc] = sum_n lmflat[base_n + rr*W + cc]
//   base_n = plane_n*M + (fy_n/T)*W + fx_n/T   for a live, in-image
//            feature (fx_n, fy_n absolute pixels at the window origin),
//          = L (the M-byte zero tail) otherwise;
// every index is clamped to the buffer's last byte, as the plain
// refine_candidates clips its gather.
//
// Replaces the TPU kernel shape_based_matching_tpu/ops/pallas/
// refine_pallas.py::_window_kernel (entry _refine_windows_pallas) plus the
// argmax half of its XLA epilogue. Plain twin:
// ops/cuda/refine.py::refine_windows_plain.
//
// Bound on the card: 256 byte loads per live feature per candidate
// (about 4e6 at 256 candidates x 63 features), scattered over a buffer
// that fits L2; the launch and the few hundred blocks, not bandwidth,
// set its time at the main path's sizes. Design: one block of 256 threads
// per candidate, thread (rr, cc) owns one window cell and sums its byte
// over the features; the features' base addresses are computed once per
// block into shared memory, in chunks, so any feature count works: no
// SMEM meta limit, no feature chunking across launches. The block argmax
// is argmax.cuh's. Candidates with live == 0 do no work and report
// best = raw = 0.

#include <cstdint>
#include <cuda_runtime.h>

#include "argmax.cuh"

namespace {

constexpr int THREADS = sbm::ARGMAX_THREADS;  // one per window cell
constexpr int FEAT_CHUNK = 256;

__global__ void __launch_bounds__(THREADS)
refine_kernel(const uint8_t* __restrict__ lmflat, long long lm_stride,
              const int* __restrict__ fx, const int* __restrict__ fy,
              const int* __restrict__ label,
              const uint8_t* __restrict__ fvalid,
              const int* __restrict__ kc, const int* __restrict__ wx,
              const int* __restrict__ wy, const uint8_t* __restrict__ live,
              int* __restrict__ best_out, int* __restrict__ raw_out, int C,
              int N, int w_img, int h_img, int T) {
  __shared__ int s_base[FEAT_CHUNK];
  __shared__ int s_val[THREADS / 32];
  __shared__ int s_idx[THREADS / 32];
  const int ci = blockIdx.y * C + blockIdx.x;
  const int tid = threadIdx.x;
  if (!live[ci]) {
    if (tid == 0) {
      best_out[ci] = 0;
      raw_out[ci] = 0;
    }
    return;
  }
  const int W = w_img / T;
  const int M = W * (h_img / T);
  const long long hi = lm_stride - 1;
  const int L = static_cast<int>(lm_stride) - M;
  const uint8_t* lm = lmflat + blockIdx.y * lm_stride;
  const int k = kc[ci];
  const int ox = wx[ci] * T;
  const int oy = wy[ci] * T;
  const int cell = (tid >> 4) * W + (tid & 15);

  int acc = 0;
  for (int n0 = 0; n0 < N; n0 += FEAT_CHUNK) {
    const int nc = min(FEAT_CHUNK, N - n0);
    __syncthreads();
    if (tid < nc) {
      const size_t f = static_cast<size_t>(k) * N + n0 + tid;
      const int x = fx[f] + ox;
      const int y = fy[f] + oy;
      int base = L;
      if (fvalid[f] && x >= 0 && x < w_img && y >= 0 && y < h_img) {
        const int plane = label[f] * (T * T) + (y % T) * T + (x % T);
        base = plane * M + (y / T) * W + (x / T);
      }
      s_base[tid] = base;
    }
    __syncthreads();
    for (int n = 0; n < nc; ++n) {
      long long idx = static_cast<long long>(s_base[n]) + cell;
      if (idx > hi) idx = hi;
      acc += __ldg(lm + idx);
    }
  }

  int v = acc, i = tid;
  sbm::block_argmax(&v, &i, s_val, s_idx);
  if (tid == 0) {
    best_out[ci] = i;
    raw_out[ci] = v;
  }
}

}  // namespace

extern "C" int sbm_refine_windows(const void* lmflat, long long lm_stride,
                                  const void* fx, const void* fy,
                                  const void* label, const void* fvalid,
                                  const void* k, const void* wx,
                                  const void* wy, const void* live,
                                  void* best, void* raw, int B, int C, int N,
                                  int w_img, int h_img, int T,
                                  void* stream) {
  const dim3 grid(C, B);
  refine_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(lmflat), lm_stride,
      static_cast<const int*>(fx), static_cast<const int*>(fy),
      static_cast<const int*>(label), static_cast<const uint8_t*>(fvalid),
      static_cast<const int*>(k), static_cast<const int*>(wx),
      static_cast<const int*>(wy), static_cast<const uint8_t*>(live),
      static_cast<int*>(best), static_cast<int*>(raw), C, N, w_img, h_img,
      T);
  return static_cast<int>(cudaGetLastError());
}
