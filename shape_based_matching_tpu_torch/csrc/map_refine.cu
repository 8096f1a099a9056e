// The map route's refine step, whole: for each candidate (k, x, y, valid)
// of B frames, the doubled position's border clamp and window origin
//   cx = min(max(2x + 1, 8T), w - width[k] - 8T),  wx = floor(cx / T) - 8
// (and the same for y), the template's map row slot = slot_of_k[k], the
// 16x16 window of the unmasked level maps
//   patch[rr, cc] = Sfull[b, min(slot*M + (wy+rr)*W + wx+cc, D*M - 1)]
// (the flat read with the row wrap, clipped to the frame's D*M cells as
// the plain refine_from_maps clips its gather, similarity.py:1087-1091 of
// the JAX package), its first-max cell, and the score epilogue
//   sim = f32(raw * 100) / f32(4 * nfeat[k]),  valid' = live && sim >= thr
// with nx = (wx + best % 16) * T + off, ny = (wy + best / 16) * T + off.
// A candidate is live when valid and slot >= 0; one that is not reads
// nothing and takes best = raw = 0, through the same epilogue.
//
// Replaces the TPU function shape_based_matching_tpu/ops/pallas/
// refine_pallas.py::_refine_from_maps_pallas: its kernel _map_window_kernel
// and the XLA work around it (origin, slot, argmax, score). Plain twin:
// ops/cuda/map_refine.py::map_refine_plain. The TPU kernel's VMEM gate
// (the maps must fit on-chip memory, D <= 80 at 1024^2) has no
// counterpart: the maps stay in device memory.
//
// Bound on the card: the int32 map cells that the live windows cover,
// each once (neighbouring windows share cells), plus 46 bytes of
// arguments and results per candidate; a few microseconds or less at
// 1024-4096 candidates, so launch latency sets the time. Design: one warp per candidate, 8 candidates per 256-thread
// block (4096 candidates fill the 132 SMs in one wave of 512 blocks).
// Lane l holds cells 32i + l, i = 0..7: row 2i + (l >> 4), column l & 15,
// so each warp load covers two 64-byte map rows, all 8 issued before any
// compare. The argmax is a strict > scan per lane in ascending cell order,
// then 5 xor shuffles that break ties toward the smaller cell: the first
// max of jnp.argmax, with no shared memory and no barrier. Lane 0 writes
// the five results; the arithmetic rounds each step as the twin does
// (the build passes --fmad=false and no fast math).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int CANDS = 8;                 // candidates (warps) per block
constexpr int THREADS = 32 * CANDS;
constexpr int WIN = 16;                  // window side
constexpr int LOADS = WIN * WIN / 32;    // cells per lane

__device__ __forceinline__ int floor_div(int a, int b) {  // b > 0
  const int q = a / b;
  return q - ((a % b != 0) & (a < 0));
}

__global__ void __launch_bounds__(THREADS)
map_refine_kernel(const int* __restrict__ Sfull, long long frame_len, int M,
                  int W, const int* __restrict__ slot_of_k,
                  const int* __restrict__ width,
                  const int* __restrict__ height,
                  const int* __restrict__ nfeat, const int* __restrict__ k,
                  const int* __restrict__ x, const int* __restrict__ y,
                  const uint8_t* __restrict__ valid,
                  const float* __restrict__ threshold,
                  int* __restrict__ k_out, int* __restrict__ x_out,
                  int* __restrict__ y_out, float* __restrict__ sim_out,
                  uint8_t* __restrict__ valid_out, int T, int w_img,
                  int h_img, int C) {
  const int c = blockIdx.x * CANDS + (threadIdx.x >> 5);
  if (c >= C) return;  // whole warps
  const int lane = threadIdx.x & 31;
  const long long ci = static_cast<long long>(blockIdx.y) * C + c;
  const int kk = __ldg(k + ci);
  const int sl = __ldg(slot_of_k + kk);
  const bool live = __ldg(valid + ci) != 0 && sl >= 0;
  const int border = 8 * T;
  const int cx = min(max(2 * __ldg(x + ci) + 1, border),
                     w_img - __ldg(width + kk) - border);
  const int cy = min(max(2 * __ldg(y + ci) + 1, border),
                     h_img - __ldg(height + kk) - border);
  const int wx = floor_div(cx, T) - 8;
  const int wy = floor_div(cy, T) - 8;
  int raw = 0, best = 0;
  if (live) {  // uniform across the warp
    const int* frame = Sfull + static_cast<long long>(blockIdx.y) * frame_len;
    const long long base =
        static_cast<long long>(sl) * M +
        static_cast<long long>(wy + (lane >> 4)) * W + wx + (lane & 15);
    int v[LOADS];
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      const long long idx = base + static_cast<long long>(2 * i) * W;
      v[i] = __ldg(frame + min(max(idx, 0LL), frame_len - 1));
    }
    raw = v[0];
    best = lane;
#pragma unroll
    for (int i = 1; i < LOADS; ++i) {
      if (v[i] > raw) {
        raw = v[i];
        best = 32 * i + lane;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const int ov = __shfl_xor_sync(0xffffffffu, raw, o);
      const int ob = __shfl_xor_sync(0xffffffffu, best, o);
      if (ov > raw || (ov == raw && ob < best)) {
        raw = ov;
        best = ob;
      }
    }
  }
  if (lane == 0) {
    const float sim = __fdiv_rn(
        __fmul_rn(__int2float_rn(raw), 100.f),
        __fmul_rn(4.f, __int2float_rn(__ldg(nfeat + kk))));
    const int off = T / 2 + (T % 2 - 1);
    k_out[ci] = kk;
    x_out[ci] = (wx + best % WIN) * T + off;
    y_out[ci] = (wy + best / WIN) * T + off;
    sim_out[ci] = sim;
    valid_out[ci] = live && sim >= __ldg(threshold);
  }
}

}  // namespace

extern "C" int sbm_map_refine(
    const void* Sfull, int D, int M, int W, const void* slot_of_k,
    const void* width, const void* height, const void* nfeat, const void* k,
    const void* x, const void* y, const void* valid, const void* threshold,
    void* k_out, void* x_out, void* y_out, void* sim_out, void* valid_out,
    int T, int w_img, int h_img, int B, int C, void* stream) {
  const dim3 grid((C + CANDS - 1) / CANDS, B);
  map_refine_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(Sfull), static_cast<long long>(D) * M, M, W,
      static_cast<const int*>(slot_of_k), static_cast<const int*>(width),
      static_cast<const int*>(height), static_cast<const int*>(nfeat),
      static_cast<const int*>(k), static_cast<const int*>(x),
      static_cast<const int*>(y), static_cast<const uint8_t*>(valid),
      static_cast<const float*>(threshold), static_cast<int*>(k_out),
      static_cast<int*>(x_out), static_cast<int*>(y_out),
      static_cast<float*>(sim_out), static_cast<uint8_t*>(valid_out), T,
      w_img, h_img, C);
  return static_cast<int>(cudaGetLastError());
}
