// The pyramid layer's two kernels around the frontend: cv::pyrDown of the
// frames, and a level's linear memories with their zero tail.
//
// pyr_down_kernel: uint8 planes [P, H, W] (gray [B, H, W] or planar color
// [B, 3, H, W] with the leading axes flattened) -> [P, H/2, W/2],
//   out[y, x] = (sum_{i,j} k[i] k[j] in[r(2y + i - 2), r(2x + j - 2)] + 128)
//               >> 8,   k = [1, 4, 6, 4, 1],
// with r() BORDER_REFLECT_101 by the two steps ops/filters.py::_pyr_rows
// takes (i < 0 -> -i, then i >= n -> 2n - 2 - i), which covers n = 2 and
// 3 too. Every sum is exact in int32 (at most 255 * 256), so the order of
// the two passes does not matter. Plain twin:
// ops/filters.py::pyr_down_u8_plain.
//
// lm_kernel: spread planes [B, H, W] (uint8, or uint16 for 16
// orientations) -> the level's flat buffer [B, n_ori*T*T*M + M] uint8,
// M = (H/T)(W/T): row ori*T*T + ty*T + tx, cell yd*(W/T) + xd holds the
// response of orientation ori to sp[yd*T + ty, xd*T + tx], then M zero
// bytes (the tail that dead and off-image features read). Responses: for
// 8 orientations 4 on the bit ori, else 3 on bit ori +- 1 (mod 8), else 0;
// for 16, 4 on a set bit within circular distance 2 of ori, else 1 within
// distance 3-4, else 0, bits 12..15 dead (ops/response.py::response_maps).
// Plain twin: ops/cuda/pyramid.py::linear_memories_plain.
//
// Both replace chains of torch operators (the JAX package computes them in
// XLA, ops/filters.py and ops/response.py there: no TPU kernel). What
// bounds them on this card: bytes, 1 read and 1/4 written a pixel for
// pyrDown, 1-2 read and n_ori + 1/T^2 written a pixel for the linear
// memories; a 1024^2 frame moves about 11 MB through both, a few
// microseconds at the card's bandwidth, so at B=1 the launch sets the
// time. Design:
// * pyrDown: a 256-thread block owns 8 output rows x 128 output columns.
//   It stages the 19 x 259 input bytes they read (halo included, the
//   reflection applied as the bytes are loaded, so edge blocks take the
//   same path) in shared memory with coalesced loads; then each thread
//   sums 4 adjacent outputs: the vertical pass on the 11 columns they
//   read (three word reads a row), the horizontal in registers, and one
//   4-byte store where the output rows are word aligned.
// * Linear memories: a 256-thread block owns XC cells of one cell row
//   (the wrapper's lm_split: T*T*XC <= 4096, XC a multiple of 16). It
//   reads the T image rows under them once, coalesced, and writes each
//   value to shared memory at its linear-memory place, run (ty, tx) of
//   XC cells; then a thread takes 16 cells of one run and stores their
//   responses for every orientation, 16 bytes a store (8 orientations:
//   the four responses of a word at once, byte lanes). Runs cut by the
//   row's end or misaligned rows store byte by byte. The block also
//   zeroes its cells' bytes of the tail. No intermediate touches device
//   memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int PD_THREADS = 256;
constexpr int PD_ROWS = 8;                    // output rows a block
constexpr int PD_COLS = 128;                  // output columns a block
constexpr int PD_IN_ROWS = 2 * PD_ROWS + 3;   // input rows they read
constexpr int PD_IN_COLS = 2 * PD_COLS + 3;   // input columns they read
constexpr int PD_LD = 264;                    // shared row, 8-byte aligned

constexpr int LM_THREADS = 256;
constexpr int LM_RUN = 16;     // cells a thread stores, 16 bytes a store
constexpr int LM_TILE = 4096;  // T*T*XC cells a block at most
constexpr int LM_PAD = 16;     // elements after each run in shared memory
constexpr int T_MAX = 16;

// BORDER_REFLECT_101 as _pyr_rows maps it; the clamp only keeps the
// indices that no output reads (a block past the frame's end) in bounds.
__device__ __forceinline__ int reflect101(int i, int n) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * n - 2 - i;
  return min(max(i, 0), n - 1);
}

__global__ void __launch_bounds__(PD_THREADS)
    pyr_down_kernel(const uint8_t* __restrict__ src,
                    uint8_t* __restrict__ dst, int H, int W) {
  __shared__ __align__(16) uint8_t tile[PD_IN_ROWS * PD_LD];
  const int H2 = H / 2, W2 = W / 2;
  const uint8_t* in = src + static_cast<long long>(blockIdx.z) * H * W;
  uint8_t* out = dst + static_cast<long long>(blockIdx.z) * H2 * W2;
  const int oy0 = blockIdx.y * PD_ROWS, ox0 = blockIdx.x * PD_COLS;
  const int iy0 = 2 * oy0 - 2, ix0 = 2 * ox0 - 2;
  for (int i = threadIdx.x; i < PD_IN_ROWS * PD_IN_COLS; i += PD_THREADS) {
    const int r = i / PD_IN_COLS, c = i - r * PD_IN_COLS;
    tile[r * PD_LD + c] =
        in[static_cast<long long>(reflect101(iy0 + r, H)) * W +
           reflect101(ix0 + c, W)];
  }
  __syncthreads();
  const int ly = threadIdx.x / 32, lx = (threadIdx.x % 32) * 4;
  const int oy = oy0 + ly, ox = ox0 + lx;
  if (oy >= H2 || ox >= W2) return;
  // v[c]: the vertical sum of tile column 2*lx + c (c = 0..10 are read)
  int v[12] = {0};
  const uint8_t* t = tile + 2 * ly * PD_LD + 2 * lx;
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const uint2 a = *reinterpret_cast<const uint2*>(t + k * PD_LD);
    const uint32_t b = *reinterpret_cast<const uint32_t*>(t + k * PD_LD + 8);
    const int w = k == 2 ? 6 : (k & 1) ? 4 : 1;
#pragma unroll
    for (int c = 0; c < 12; ++c) {
      const uint32_t word = c < 4 ? a.x : c < 8 ? a.y : b;
      v[c] += w * static_cast<int>((word >> (8 * (c & 3))) & 0xFFu);
    }
  }
  uint32_t packed = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int acc = v[2 * j] + 4 * v[2 * j + 1] + 6 * v[2 * j + 2] +
                    4 * v[2 * j + 3] + v[2 * j + 4];
    packed |= static_cast<uint32_t>((acc + 128) >> 8) << (8 * j);
  }
  uint8_t* o = out + static_cast<long long>(oy) * W2 + ox;
  if ((W2 & 3) == 0) {  // rows and the plane start on words: 4 outputs
    *reinterpret_cast<uint32_t*>(o) = packed;
  } else {
    for (int j = 0; j < 4 && ox + j < W2; ++j)
      o[j] = static_cast<uint8_t>(packed >> (8 * j));
  }
}

// The response of orientation ori to one spread value.
template <int NORI>
__device__ __forceinline__ uint32_t response(uint32_t s, int ori) {
  if (NORI == 8) {
    if ((s >> ori) & 1u) return 4u;
    return ((s >> ((ori + 1) & 7)) | (s >> ((ori + 7) & 7))) & 1u ? 3u : 0u;
  }
  uint32_t near = 0, mid = 0;
#pragma unroll
  for (int d = -4; d <= 4; ++d) {
    const uint32_t bit = 1u << ((ori + d) & 15);
    if (d >= -2 && d <= 2) near |= bit;
    else if (d != 0) mid |= bit;
  }
  const uint32_t live = 0xFFFu;  // bits 12..15 are dead
  return (s & near & live) ? 4u : (s & mid & live) ? 1u : 0u;
}

// The responses of orientation ori to the four uint8 spread values of a
// word, in byte lanes (8 orientations): bit 0 of each lane after a shift
// by at most 7 is bit `shift` of that lane.
__device__ __forceinline__ uint32_t response8x4(uint32_t w, int ori) {
  const uint32_t e = (w >> ori) & 0x01010101u;
  const uint32_t n =
      ((w >> ((ori + 1) & 7)) | (w >> ((ori + 7) & 7))) & 0x01010101u;
  return (e << 2) | ((n & ~e) * 3u);
}

template <typename S, int NORI>
__global__ void __launch_bounds__(LM_THREADS)
    lm_kernel(const S* __restrict__ sp, uint8_t* __restrict__ out, int H,
              int W, int T, int XC) {
  __shared__ __align__(16) S tile[LM_TILE + T_MAX * T_MAX * LM_PAD];
  const int Wd = W / T, Hd = H / T;
  const long long M = static_cast<long long>(Hd) * Wd;
  const long long TTM = static_cast<long long>(T) * T * M;
  const int yd = blockIdx.y, xd0 = blockIdx.x * XC;
  const int xc = min(XC, Wd - xd0);
  const int ld = XC + LM_PAD;
  const int cols = xc * T;
  const S* in = sp + (static_cast<long long>(blockIdx.z) * H +
                      static_cast<long long>(yd) * T) * W +
                static_cast<long long>(xd0) * T;
  for (int i = threadIdx.x; i < T * cols; i += LM_THREADS) {
    const int ty = i / cols, x = i - ty * cols;
    const int xd = x / T, tx = x - xd * T;
    tile[(ty * T + tx) * ld + xd] = in[static_cast<long long>(ty) * W + x];
  }
  uint8_t* base = out + blockIdx.z * (NORI * TTM + M) +
                  static_cast<long long>(yd) * Wd + xd0;
  for (int i = threadIdx.x; i < xc; i += LM_THREADS) base[NORI * TTM + i] = 0;
  __syncthreads();
  const int groups = (xc + LM_RUN - 1) / LM_RUN;
  for (int it = threadIdx.x; it < T * T * groups; it += LM_THREADS) {
    const int r = it / groups, g = it - r * groups;
    const int n = min(LM_RUN, xc - g * LM_RUN);
    const S* run = tile + r * ld + g * LM_RUN;
    uint8_t* d = base + r * M + g * LM_RUN;
    // 16-byte stores need the run whole and every orientation's row
    // aligned: d and T*T*M on 16 bytes
    if (n == LM_RUN && ((reinterpret_cast<uintptr_t>(d) | TTM) & 15) == 0) {
      uint32_t s[LM_RUN];  // 8 orientations: 4 cells a word, else 1
      if (NORI == 8) {
        const uint4 q = *reinterpret_cast<const uint4*>(run);
        s[0] = q.x;
        s[1] = q.y;
        s[2] = q.z;
        s[3] = q.w;
      } else {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint4 q = reinterpret_cast<const uint4*>(run)[h];
          const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
          for (int c = 0; c < 8; ++c)
            s[8 * h + c] = (w[c >> 1] >> (16 * (c & 1))) & 0xFFFFu;
        }
      }
#pragma unroll
      for (int ori = 0; ori < NORI; ++ori) {
        uint32_t o[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (NORI == 8) {
            o[q] = response8x4(s[q], ori);
          } else {
            o[q] = 0;
#pragma unroll
            for (int c = 0; c < 4; ++c)
              o[q] |= response<NORI>(s[4 * q + c], ori) << (8 * c);
          }
        }
        *reinterpret_cast<uint4*>(d + ori * TTM) =
            make_uint4(o[0], o[1], o[2], o[3]);
      }
    } else {
      for (int c = 0; c < n; ++c) {
        const uint32_t s = run[c];
#pragma unroll
        for (int ori = 0; ori < NORI; ++ori)
          d[ori * TTM + c] = static_cast<uint8_t>(response<NORI>(s, ori));
      }
    }
  }
}

template <typename S, int NORI>
int launch_lm(const void* sp, void* out, int B, int H, int W, int T, int XC,
              cudaStream_t stream) {
  const dim3 grid((W / T + XC - 1) / XC, H / T, B);
  lm_kernel<S, NORI><<<grid, LM_THREADS, 0, stream>>>(
      static_cast<const S*>(sp), static_cast<uint8_t*>(out), H, W, T, XC);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// src [planes, H, W] uint8 -> dst [planes, H/2, W/2] uint8.
extern "C" int sbm_pyr_down(const void* src, void* dst, int planes, int H,
                            int W, void* stream) {
  if (planes < 1 || planes > 65535 || H < 2 || W < 2 ||
      (H / 2 + PD_ROWS - 1) / PD_ROWS > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((W / 2 + PD_COLS - 1) / PD_COLS,
                  (H / 2 + PD_ROWS - 1) / PD_ROWS, planes);
  pyr_down_kernel<<<grid, PD_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), static_cast<uint8_t*>(dst), H, W);
  return static_cast<int>(cudaGetLastError());
}

// sp [B, H, W] (uint8 for 8 orientations, uint16 for 16) -> out [B,
// n_ori*T*T*M + M] uint8, XC cells a block (T*T*XC <= 4096, XC a multiple
// of 16).
extern "C" int sbm_linear_memories(const void* sp, void* out, int B, int H,
                                   int W, int T, int XC, int n_ori,
                                   void* stream) {
  if (T < 1 || T > T_MAX || H % T || W % T || H < T || W < T || B < 1 ||
      B > 65535 || H / T > 65535 || XC < LM_RUN || XC % LM_RUN ||
      T * T * XC > LM_TILE)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if (n_ori == 8) return launch_lm<uint8_t, 8>(sp, out, B, H, W, T, XC, s);
  if (n_ori == 16)
    return launch_lm<uint16_t, 16>(sp, out, B, H, W, T, XC, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
