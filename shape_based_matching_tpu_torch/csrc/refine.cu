// Windowed candidate refinement (16x16 local similarity) straight from
// the linear memories, with the first-max argmax:
//   patch[rr, cc] = sum_n lmflat[base_n + rr*W + cc]
//   base_n = plane_n*M + (fy_n/T)*W + fx_n/T   for a live, in-image
//            feature (fx_n, fy_n absolute pixels at the window origin),
//          = L (the M-byte zero tail) otherwise;
// every index is clamped to the frame's last byte, as the plain
// refine_candidates clips its gather.
//
// Replaces the TPU kernel shape_based_matching_tpu/ops/pallas/
// refine_pallas.py::_window_kernel (entry _refine_windows_pallas) plus the
// argmax half of its XLA epilogue. Plain twin:
// ops/cuda/refine.py::refine_windows_plain.
//
// What bounds it on this card: the L1 requests of the window rows. Each
// feature of each live candidate reads 16 rows of 16 bytes, W bytes
// apart, so a warp's load touches one 128-byte line per row it covers,
// and an SM serves about one line a clock; the lines (not the bytes,
// which fit L2) set the time. At the flagship's 256 candidates x 63
// features the launch and the few hundred blocks set it. The first
// design gave each of 256 threads one cell and every feature of its
// candidate: at 9126 features (the 8191-feature bank) one block per
// candidate walked them one byte load after another, 16 warps on each
// SM, at 1.9% of the bound.
// Design:
// * Word-wide rows. A thread owns 4 cells of a row and reads the two
//   aligned words that cover them, lined up with __funnelshift_r, so
//   bases of any alignment work. The 4 bytes add in one 32-bit add:
//   lmflat bytes are responses, at most 4, so a lane holds 63 features
//   (252) without a carry; lanes are widened after every run of
//   LANE_FEATS features.
// * Frame ends. A thread whose words could pass the frame's last byte
//   reads byte by byte with every index clamped to the last byte,
//   exactly as the twin; so a word never reads the next frame's head,
//   nor past the tensor. A word's low bytes may lie before the frame
//   (the previous frame, or the aligned word holding the tensor's first
//   byte): they are shifted out.
// * Short banks (window_kernel, up to FEATS_PER_BLOCK features: the
//   flagship's 63): one block per candidate and the whole bank; its 4
//   warp pairs each own the window (a thread: 4 cells of one row) and
//   every 4th feature, and meet in shared memory before the argmax.
// * Long banks (cluster_kernel, the wrapper's refine_split past
//   FEATS_PER_BLOCK features): a warp holds 8 consecutive candidates, a
//   thread 4 columns of all 16 rows of one of them, so one load
//   instruction reads the same row of 8 windows. Candidates come in
//   template-major order, neighbours on the coarse grid (or the same
//   window, clamped at the border), so those 8 rows share one or two
//   lines where the window kernel's rows touched eight. The block's 8
//   warps each take every 8th feature of the 8 candidates; the features
//   are cut into G groups across blocks (grid (ceil(C / 8), G, B)). A
//   thread's packed runs go straight into the block's patches in shared
//   memory, which keeps it at 16 packed words (4 blocks an SM).
//   The feature groups meet by integer atomicAdd in a zeroed [B, C, 256]
//   scratch, whose argmax a second pass takes. The sums are exact in any
//   order, so the first max in cell order rr*16 + cc (argmax.cuh's rule)
//   cannot change.
// Candidates with live == 0 do no work and report best = raw = 0.

#include <cstdint>
#include <cuda_runtime.h>

#include "argmax.cuh"

namespace {

constexpr int THREADS = sbm::ARGMAX_THREADS;  // 256 cells of a window
constexpr int GROUP = 64;                     // threads of one window
constexpr int GROUPS = THREADS / GROUP;
constexpr int LANE_FEATS = 63;                // features per packed run
constexpr int FEAT_CHUNK = GROUPS * LANE_FEATS;  // bases staged at a time
constexpr int CANDS = 8;                      // candidates of a cluster
constexpr int SHARES = THREADS / 32;          // warps of a cluster block
constexpr int CLUSTER_CHUNK = SHARES * LANE_FEATS;

__device__ __forceinline__ uint32_t load4(const uint8_t* a) {
  const uintptr_t u = reinterpret_cast<uintptr_t>(a);
  const uint32_t* w = reinterpret_cast<const uint32_t*>(u & ~uintptr_t{3});
  return __funnelshift_r(__ldg(w), __ldg(w + 1),
                         static_cast<uint32_t>(u & 3) * 8);
}

// Bytes a .. a+3 of the frame, each index clamped to `last`.
__device__ __forceinline__ uint32_t load4_clamped(const uint8_t* lm, int a,
                                                  int last) {
  uint32_t v = 0;
#pragma unroll
  for (int u = 0; u < 4; ++u)
    v |= static_cast<uint32_t>(__ldg(lm + min(a + u, last))) << (8 * u);
  return v;
}

// Flat address of feature f at window origin (ox, oy) pixels; L for a
// dead or off-image feature.
__device__ __forceinline__ int feature_base(
    const int* __restrict__ fx, const int* __restrict__ fy,
    const int* __restrict__ label, const uint8_t* __restrict__ fvalid,
    size_t f, int ox, int oy, int w_img, int h_img, int T, int W, int M,
    int L) {
  const int x = fx[f] + ox;
  const int y = fy[f] + oy;
  if (!(fvalid[f] && x >= 0 && x < w_img && y >= 0 && y < h_img)) return L;
  const int plane = label[f] * (T * T) + (y % T) * T + (x % T);
  return plane * M + (y / T) * W + (x / T);
}

struct Geometry {
  int W, M, last, L;
};

__device__ __forceinline__ Geometry geometry(long long lm_stride, int w_img,
                                             int h_img, int T) {
  const int W = w_img / T;
  const int M = W * (h_img / T);
  return {W, M, static_cast<int>(lm_stride) - 1,
          static_cast<int>(lm_stride) - M};
}

// One candidate per block, the whole bank: warp pair g owns the window
// and features g, g + 4, ...
__global__ void __launch_bounds__(THREADS)
window_kernel(const uint8_t* __restrict__ lmflat, long long lm_stride,
              const int* __restrict__ fx, const int* __restrict__ fy,
              const int* __restrict__ label,
              const uint8_t* __restrict__ fvalid,
              const int* __restrict__ kc, const int* __restrict__ wx,
              const int* __restrict__ wy, const uint8_t* __restrict__ live,
              int* __restrict__ best_out, int* __restrict__ raw_out, int C,
              int N, int w_img, int h_img, int T) {
  __shared__ int s_base[FEAT_CHUNK];
  __shared__ __align__(16) int s_sum[GROUPS][THREADS];
  __shared__ int s_val[THREADS / 32];
  __shared__ int s_idx[THREADS / 32];
  const int tid = threadIdx.x;
  const size_t ci = static_cast<size_t>(blockIdx.y) * C + blockIdx.x;
  if (!live[ci]) {
    if (tid == 0) best_out[ci] = raw_out[ci] = 0;
    return;
  }
  const Geometry g = geometry(lm_stride, w_img, h_img, T);
  const uint8_t* lm = lmflat + blockIdx.y * lm_stride;
  const int share = tid / GROUP;
  const int rr = (tid % GROUP) >> 2;
  const int cc0 = (tid & 3) * 4;
  const int roff = rr * g.W + cc0;
  const int k = kc[ci];
  const int ox = wx[ci] * T;
  const int oy = wy[ci] * T;

  int acc[4] = {0, 0, 0, 0};
  for (int n0 = 0; n0 < N; n0 += FEAT_CHUNK) {
    const int nc = min(FEAT_CHUNK, N - n0);
    __syncthreads();
    if (tid < nc)
      s_base[tid] = feature_base(fx, fy, label, fvalid,
                                 static_cast<size_t>(k) * N + n0 + tid, ox,
                                 oy, w_img, h_img, T, g.W, g.M, g.L);
    __syncthreads();
    uint32_t pk = 0;  // at most FEAT_CHUNK / GROUPS = LANE_FEATS features
#pragma unroll 8
    for (int i = share; i < nc; i += GROUPS) {
      const int a = s_base[i] + roff;
      pk += a + 7 <= g.last ? load4(lm + a) : load4_clamped(lm, a, g.last);
    }
    acc[0] += pk & 0xFFu;
    acc[1] += (pk >> 8) & 0xFFu;
    acc[2] += (pk >> 16) & 0xFFu;
    acc[3] += pk >> 24;
  }

  *reinterpret_cast<int4*>(&s_sum[share][rr * 16 + cc0]) =
      make_int4(acc[0], acc[1], acc[2], acc[3]);
  __syncthreads();
  int v = 0;
#pragma unroll
  for (int s = 0; s < GROUPS; ++s) v += s_sum[s][tid];
  int i = tid;
  sbm::block_argmax(&v, &i, s_val, s_idx);
  if (tid == 0) {
    best_out[ci] = i;
    raw_out[ci] = v;
  }
}

// Eight candidates per block, features [n_begin, n_end): lane quad q of
// every warp holds candidate c_first + q (4 columns, 16 rows a thread);
// warp w takes features n_begin + w, + 8, ... The block adds its partial
// patches into `part`.
__global__ void __launch_bounds__(THREADS)
cluster_kernel(const uint8_t* __restrict__ lmflat, long long lm_stride,
               const int* __restrict__ fx, const int* __restrict__ fy,
               const int* __restrict__ label,
               const uint8_t* __restrict__ fvalid,
               const int* __restrict__ kc, const int* __restrict__ wx,
               const int* __restrict__ wy, const uint8_t* __restrict__ live,
               int* __restrict__ part, int C, int N, int w_img, int h_img,
               int T, int chunk) {
  __shared__ int s_base[CANDS][CLUSTER_CHUNK];
  __shared__ int s_patch[CANDS][THREADS];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int c_first = blockIdx.x * CANDS;
  const size_t row0 = static_cast<size_t>(blockIdx.z) * C;

  bool any = false;  // uniform over the block
#pragma unroll
  for (int q = 0; q < CANDS; ++q)
    any |= c_first + q < C && live[row0 + c_first + q];
  if (!any) return;
  for (int i = tid; i < CANDS * THREADS; i += THREADS)
    (&s_patch[0][0])[i] = 0;

  const Geometry g = geometry(lm_stride, w_img, h_img, T);
  const uint8_t* lm = lmflat + blockIdx.z * lm_stride;
  const int q = lane >> 2;
  const int cc0 = (lane & 3) * 4;
  const bool mine = c_first + q < C && live[row0 + c_first + q];
  // warp w stages the bases of candidate c_first + w
  const int sc = c_first + warp;
  const bool s_ok = sc < C && live[row0 + sc];
  const int sk = s_ok ? kc[row0 + sc] : 0;
  const int sox = s_ok ? wx[row0 + sc] * T : 0;
  const int soy = s_ok ? wy[row0 + sc] * T : 0;
  const int reach = 15 * g.W + 7;  // past a row-0 address, to the last word

  const int n_begin = blockIdx.y * chunk;
  const int n_end = min(N, n_begin + chunk);
  for (int n0 = n_begin; n0 < n_end; n0 += CLUSTER_CHUNK) {
    const int nc = min(CLUSTER_CHUNK, n_end - n0);
    __syncthreads();
    if (s_ok) {
#pragma unroll 4
      for (int i = lane; i < nc; i += 32)
        s_base[warp][i] = feature_base(
            fx, fy, label, fvalid, static_cast<size_t>(sk) * N + n0 + i,
            sox, soy, w_img, h_img, T, g.W, g.M, g.L);
    }
    __syncthreads();
    if (!mine) continue;
    uint32_t pk[16];  // at most CLUSTER_CHUNK / SHARES = LANE_FEATS features
#pragma unroll
    for (int rr = 0; rr < 16; ++rr) pk[rr] = 0;
    for (int i = warp; i < nc; i += SHARES) {
      const int a = s_base[q][i] + cc0;
      if (a + reach <= g.last) {
#pragma unroll
        for (int rr = 0; rr < 16; ++rr) pk[rr] += load4(lm + a + rr * g.W);
      } else {
#pragma unroll
        for (int rr = 0; rr < 16; ++rr)
          pk[rr] += load4_clamped(lm, a + rr * g.W, g.last);
      }
    }
#pragma unroll
    for (int rr = 0; rr < 16; ++rr) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int v = (pk[rr] >> (8 * u)) & 0xFFu;
        if (v) atomicAdd(&s_patch[q][rr * 16 + cc0 + u], v);
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < CANDS * THREADS; i += THREADS) {
    const int cq = c_first + i / THREADS;
    const int v = (&s_patch[0][0])[i];
    if (v && cq < C && live[row0 + cq])
      atomicAdd(part + (row0 + cq) * THREADS + i % THREADS, v);
  }
}

// The argmax of cluster_kernel's summed patches: grid (C, B).
__global__ void __launch_bounds__(THREADS)
argmax_kernel(const int* __restrict__ part, const uint8_t* __restrict__ live,
              int* __restrict__ best_out, int* __restrict__ raw_out, int C) {
  __shared__ int s_val[THREADS / 32];
  __shared__ int s_idx[THREADS / 32];
  const size_t ci = static_cast<size_t>(blockIdx.y) * C + blockIdx.x;
  const int tid = threadIdx.x;
  if (!live[ci]) {
    if (tid == 0) best_out[ci] = raw_out[ci] = 0;
    return;
  }
  int v = part[ci * THREADS + tid], i = tid;
  sbm::block_argmax(&v, &i, s_val, s_idx);
  if (tid == 0) {
    best_out[ci] = i;
    raw_out[ci] = v;
  }
}

}  // namespace

// CB (candidates per block) 1: window_kernel, the whole bank in one
// block (G == 1). CB 8: cluster_kernel in G feature groups of `chunk`
// into `part`, a zeroed [B, C, 256] int32 scratch, then argmax_kernel.
extern "C" int sbm_refine_windows(const void* lmflat, long long lm_stride,
                                  const void* fx, const void* fy,
                                  const void* label, const void* fvalid,
                                  const void* k, const void* wx,
                                  const void* wy, const void* live,
                                  void* best, void* raw, void* part, int B,
                                  int C, int N, int w_img, int h_img, int T,
                                  int CB, int G, int chunk, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* lm = static_cast<const uint8_t*>(lmflat);
  const auto* ifx = static_cast<const int*>(fx);
  const auto* ify = static_cast<const int*>(fy);
  const auto* ilabel = static_cast<const int*>(label);
  const auto* valid = static_cast<const uint8_t*>(fvalid);
  const auto* ik = static_cast<const int*>(k);
  const auto* iwx = static_cast<const int*>(wx);
  const auto* iwy = static_cast<const int*>(wy);
  const auto* ulive = static_cast<const uint8_t*>(live);
  auto* ibest = static_cast<int*>(best);
  auto* iraw = static_cast<int*>(raw);
  if (CB == 1 && G == 1) {
    window_kernel<<<dim3(C, B), THREADS, 0, st>>>(
        lm, lm_stride, ifx, ify, ilabel, valid, ik, iwx, iwy, ulive, ibest,
        iraw, C, N, w_img, h_img, T);
    return static_cast<int>(cudaGetLastError());
  }
  if (CB != CANDS || part == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cluster_kernel<<<dim3((C + CANDS - 1) / CANDS, G, B), THREADS, 0, st>>>(
      lm, lm_stride, ifx, ify, ilabel, valid, ik, iwx, iwy, ulive,
      static_cast<int*>(part), C, N, w_img, h_img, T, chunk);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  argmax_kernel<<<dim3(C, B), THREADS, 0, st>>>(
      static_cast<const int*>(part), ulive, ibest, iraw, C);
  return static_cast<int>(cudaGetLastError());
}
