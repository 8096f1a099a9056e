// The ICP layer's edge field: the edge frontend (7-tap Q8 blur, 3x3 Sobel,
// |grad|^2, the folded octant, the non-max suppression along it, unit
// normals, the parabola's subpixel shift, the flood's seed planes) in one
// launch, then the jump flood in one launch a stride, the last of which
// writes the offsets to the nearest edge and the within-radius mask.
//
// Port-only kernels: the JAX package computes the field in XLA
// (shape_based_matching_tpu/models/icp.py::_edge_frontend_impl and
// _jump_flood_impl), with no Pallas kernel. Plain twin:
// models/icp.py::edge_nearest_field_plain (_edge_frontend, _jump_flood,
// _flood_epilogue), about 860 torch ops a frame at radius 8.
//
// What bounds it on this card: neither bytes nor operations. A frame is
// 1 byte a pixel in and 21 out (the seed planes 8 more a stride, mostly
// from L2), a few hundred integer and float operations a pixel; at B=1 the
// host's launches were the cost (about 15 us of host time each), so the
// design is as few launches as the flood's order allows.
//
// Design:
// * Frontend: a block a 32 x 32 output tile. It stages the tile and a
//   5-pixel halo of the frame in shared memory with BORDER_REPLICATE
//   (blur 3, Sobel 1, NMS 1), blurs vertically then horizontally (the
//   same exact integer sums as ops/filters.gaussian_blur7_u8), and
//   computes dx, dy and |grad|^2 on the tile and a 1-pixel ring (-1 outside
//   the frame: the NMS's padding), then each output pixel. The seed
//   planes (the pixel's row and column where it is an edge, BIG elsewhere)
//   are written in the same launch.
// * Flood: within a stride the 8 neighbours run in the twin's order, dr
//   outer, each reading the seeds as the neighbours before it left them
//   across the whole frame (Gauss-Seidel across neighbours, Jacobi within
//   one). The neighbours' row offsets are three -s, two 0 and three +s, and
//   likewise the columns', so a pixel's seed after the stride depends on
//   the stride's input within +-3s on each axis. A block takes a 32 x 32
//   output tile, stages its seeds and a 3s halo (BIG outside the frame,
//   never updated), runs the 8 sub-sweeps in shared memory (each reads,
//   synchronises, writes, synchronises) and writes its tile to the other
//   buffer: updating in place would race with the neighbouring tiles'
//   halos. A cell whose neighbour lies outside the staged region keeps its
//   seed; no output pixel reads such a cell. Strides above HALO_STRIDE_MAX,
//   whose halo would not fit in shared memory, take 8 ping-pong launches,
//   one a neighbour, which is exact too.
// * The current distance is recomputed from the seed (the twin's `best`
//   always equals dist2 of its seed), so no distance plane is stored.
//
// Semantics match the twin bit for bit on the card:
// * blur and Sobel are exact integer sums, BORDER_REPLICATE;
// * the octant round(atan2(dy, dx) / f32(pi/4)) mod 4 is an exact integer
//   test (octant4); the twin's float arithmetic gives the same octant for
//   every integer gradient in [-1020, 1020]^2 (tests/test_torch_icp.py
//   replays octant4 in NumPy against the twin's octant);
// * normals and subpixel shifts keep the twin's order of operations and
//   its float32 constants, with IEEE sqrt and division;
// * the flood's squared distances are float32, each product and the sum
//   rounded (not integers: past 2^24 the twin's rounding can tie where
//   integers would not), FAR without a seed, taken where strictly less.
//
// Compile with --fmad=false and without --use_fast_math (ops/cuda/build.py).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BIG = 1 << 20;       // models/icp.py BIG: "no seed"
constexpr float FAR = 1e18f;       // models/icp.py FAR
constexpr int FE_TILE = 32;        // frontend output tile (square)
constexpr int FE_THREADS = 256;
constexpr int FLOOD_TH = 32;       // flood output tile rows
constexpr int FLOOD_TW = 32;       // flood output tile columns
constexpr int FLOOD_THREADS = 512;
constexpr int HALO_STRIDE_MAX = 8;  // the largest stride one launch takes
constexpr int STEP_THREADS = 256;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// The Q8 taps of cv::GaussianBlur(7x7, sigma 0): 8 28 56 72 56 28 8.
__device__ __forceinline__ int gauss7(int a0, int a1, int a2, int a3, int a4,
                                      int a5, int a6) {
  return 8 * (a0 + a6) + 28 * (a1 + a5) + 56 * (a2 + a4) + 72 * a3;
}

// round(atan2(dy, dx) / (pi/4)) mod 4 of an integer gradient, exactly: 0
// where |dy| <= tan(pi/8) |dx| (and at (0, 0)), 2 where |dx| < tan(pi/8)
// |dy|, else 1 where dx and dy share a sign and 3 where they do not. With
// tan(pi/8) = sqrt(2) - 1, |dy| < tan(pi/8) |dx| iff (|dx| + |dy|)^2 <
// 2 dx^2; equality holds only at (0, 0), sqrt(2) being irrational.
__device__ __forceinline__ int octant4(int dx, int dy) {
  const int ax = abs(dx), ay = abs(dy);
  const int s = (ax + ay) * (ax + ay);
  if (s <= 2 * ax * ax) return 0;
  if (s < 2 * ay * ay) return 2;
  return (dx > 0) == (dy > 0) ? 1 : 3;
}

// grid (ceil(W / FE_TILE), ceil(H / FE_TILE)), FE_THREADS threads.
__global__ void __launch_bounds__(FE_THREADS)
field_frontend_kernel(const uint8_t* __restrict__ src,
                      bool* __restrict__ edge, float2* __restrict__ normal,
                      float2* __restrict__ subpix, int2* __restrict__ seed,
                      int H, int W, float thr_sq) {
  constexpr int SS = FE_TILE + 10;  // frame rows/columns y0-5 .., x0-5 ..
  constexpr int BS = FE_TILE + 4;   // blurred rows/columns y0-2 .., x0-2 ..
  constexpr int MS = FE_TILE + 2;   // gradients y0-1 .., x0-1 ..
  __shared__ int s_src[SS][SS];
  __shared__ int s_v[BS][SS];
  __shared__ int s_b[BS][BS];
  __shared__ int s_dx[MS][MS], s_dy[MS][MS], s_m[MS][MS];
  const int y0 = blockIdx.y * FE_TILE, x0 = blockIdx.x * FE_TILE;
  const int t = threadIdx.x;

  for (int i = t; i < SS * SS; i += FE_THREADS) {
    const int r = i / SS, c = i % SS;
    s_src[r][c] = src[static_cast<size_t>(clampi(y0 - 5 + r, 0, H - 1)) * W +
                      clampi(x0 - 5 + c, 0, W - 1)];
  }
  __syncthreads();
  // blurred row r holds the frame row clamp(y0 - 2 + r): its taps are the
  // frame rows around that row, staged from y0 - 5 (the blurred image
  // replicated, as Sobel reads it)
  for (int i = t; i < BS * SS; i += FE_THREADS) {
    const int r = i / SS, c = i % SS;
    const int b = clampi(y0 - 2 + r, 0, H - 1) - y0 + 2;
    s_v[r][c] = gauss7(s_src[b][c], s_src[b + 1][c], s_src[b + 2][c],
                       s_src[b + 3][c], s_src[b + 4][c], s_src[b + 5][c],
                       s_src[b + 6][c]);
  }
  __syncthreads();
  for (int i = t; i < BS * BS; i += FE_THREADS) {
    const int r = i / BS, c = i % BS;
    const int b = clampi(x0 - 2 + c, 0, W - 1) - x0 + 2;
    const int* v = s_v[r] + b;
    s_b[r][c] = (gauss7(v[0], v[1], v[2], v[3], v[4], v[5], v[6]) +
                 (1 << 15)) >> 16;
  }
  __syncthreads();
  // Sobel (smooth [1, 2, 1] times diff [-1, 0, 1]) and |grad|^2 on the tile
  // and its ring; -1 outside the frame
  for (int i = t; i < MS * MS; i += FE_THREADS) {
    const int r = i / MS, c = i % MS;
    const int y = y0 - 1 + r, x = x0 - 1 + c;
    int dx = 0, dy = 0, m = -1;
    if (y >= 0 && y < H && x >= 0 && x < W) {
      const int ru = clampi(y - 1, 0, H - 1) - y0 + 2, rc = y - y0 + 2;
      const int rd = clampi(y + 1, 0, H - 1) - y0 + 2;
      const int cl = clampi(x - 1, 0, W - 1) - x0 + 2, cc = x - x0 + 2;
      const int cr = clampi(x + 1, 0, W - 1) - x0 + 2;
      dx = (s_b[ru][cr] + 2 * s_b[rc][cr] + s_b[rd][cr]) -
           (s_b[ru][cl] + 2 * s_b[rc][cl] + s_b[rd][cl]);
      dy = (s_b[rd][cl] + 2 * s_b[rd][cc] + s_b[rd][cr]) -
           (s_b[ru][cl] + 2 * s_b[ru][cc] + s_b[ru][cr]);
      m = dx * dx + dy * dy;  // <= 2 * 1020^2: exact as float32 too
    }
    s_dx[r][c] = dx;
    s_dy[r][c] = dy;
    s_m[r][c] = m;
  }
  __syncthreads();
  for (int i = t; i < FE_TILE * FE_TILE; i += FE_THREADS) {
    const int r = i / FE_TILE, c = i % FE_TILE;
    const int y = y0 + r, x = x0 + c;
    if (y >= H || x >= W) continue;
    const int dx = s_dx[r + 1][c + 1], dy = s_dy[r + 1][c + 1];
    const int m = s_m[r + 1][c + 1];
    // the unit step along octant 0..3, (column, row): (1, 0) (1, 1)
    // (0, 1) (-1, 1); the forward neighbour lies there, the backward one
    // opposite
    const int o = octant4(dx, dy);
    const int sr = o == 0 ? 0 : 1;
    const int sc = o == 2 ? 0 : (o == 3 ? -1 : 1);
    const int fwd = s_m[r + 1 + sr][c + 1 + sc];
    const int bwd = s_m[r + 1 - sr][c + 1 - sc];
    const bool e = static_cast<float>(m) > thr_sq && m >= fwd && m >= bwd;

    const float fx = static_cast<float>(dx), fy = static_cast<float>(dy);
    const float mag = fx * fx + fy * fy;
    const float inv = __fsqrt_rn(fmaxf(mag, 1e-12f));
    const float g0 = __fsqrt_rn(fmaxf(mag, 0.0f));
    const float gf = __fsqrt_rn(fmaxf(static_cast<float>(fwd), 0.0f));
    const float gb = __fsqrt_rn(fmaxf(static_cast<float>(bwd), 0.0f));
    const float denom = (gb - 2.0f * g0) + gf;
    float delta =
        fabsf(denom) > 1e-6f ? __fdiv_rn(0.5f * (gb - gf), denom) : 0.0f;
    delta = fminf(fmaxf(delta, -0.5f), 0.5f);

    const size_t p = static_cast<size_t>(y) * W + x;
    edge[p] = e;
    normal[p] = make_float2(__fdiv_rn(fx, inv), __fdiv_rn(fy, inv));
    subpix[p] = make_float2(delta * static_cast<float>(sc),
                            delta * static_cast<float>(sr));
    seed[p] = e ? make_int2(y, x) : make_int2(BIG, BIG);
  }
}

// The twin's dist2: float32 (dr*dr + dc*dc), each step rounded; FAR
// without a seed.
__device__ __forceinline__ float dist2(int2 s, int y, int x) {
  if (s.x >= BIG) return FAR;
  const float dr = static_cast<float>(s.x - y);
  const float dc = static_cast<float>(s.y - x);
  return __fadd_rn(__fmul_rn(dr, dr), __fmul_rn(dc, dc));
}

// One stride of S <= HALO_STRIDE_MAX. grid (ceil(W / FLOOD_TW),
// ceil(H / FLOOD_TH)), FLOOD_THREADS threads, (FLOOD_TH + 6S) x
// (FLOOD_TW + 6S) int2 of dynamic shared memory. Writes the tile's seeds
// to `out`, or, where `off` is given (the last stride), the offsets (dx,
// dy) to the seed (0 without one) and the within-radius mask.
template <int S>
__global__ void __launch_bounds__(FLOOD_THREADS)
flood_tile_kernel(const int2* __restrict__ in, int2* __restrict__ out,
                  int2* __restrict__ off, bool* __restrict__ has, int H,
                  int W, int radius) {
  constexpr int SH = FLOOD_TH + 6 * S, SW = FLOOD_TW + 6 * S;
  constexpr int N = SH * SW;
  constexpr int K = (N + FLOOD_THREADS - 1) / FLOOD_THREADS;
  extern __shared__ int2 s_seed[];
  const int ty = static_cast<int>(blockIdx.y) * FLOOD_TH - 3 * S;
  const int tx = static_cast<int>(blockIdx.x) * FLOOD_TW - 3 * S;
  const int t = threadIdx.x;

  for (int i = t; i < N; i += FLOOD_THREADS) {
    const int y = ty + i / SW, x = tx + i % SW;
    s_seed[i] = (y >= 0 && y < H && x >= 0 && x < W)
                    ? in[static_cast<size_t>(y) * W + x]
                    : make_int2(BIG, BIG);
  }
  __syncthreads();

#pragma unroll 1
  for (int n = 0; n < 8; ++n) {
    // (dr, dc) in {-S, 0, S}^2 but (0, 0), dr outer
    const int q = n < 4 ? n : n + 1;
    const int dr = (q / 3 - 1) * S, dc = (q % 3 - 1) * S;
    int2 pend[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = t + k * FLOOD_THREADS;
      if (i < N) {
        const int r = i / SW, c = i % SW;
        const int y = ty + r, x = tx + c;
        int2 cur = s_seed[i];
        const int rn = r + dr, cn = c + dc;
        if (y >= 0 && y < H && x >= 0 && x < W && rn >= 0 && rn < SH &&
            cn >= 0 && cn < SW) {
          const int2 cand = s_seed[rn * SW + cn];
          if (dist2(cand, y, x) < dist2(cur, y, x)) cur = cand;
        }
        pend[k] = cur;
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = t + k * FLOOD_THREADS;
      if (i < N) s_seed[i] = pend[k];
    }
    __syncthreads();
  }

  for (int i = t; i < FLOOD_TH * FLOOD_TW; i += FLOOD_THREADS) {
    const int r = i / FLOOD_TW + 3 * S, c = i % FLOOD_TW + 3 * S;
    const int y = ty + r, x = tx + c;
    if (y >= H || x >= W) continue;
    const int2 s = s_seed[r * SW + c];
    const size_t p = static_cast<size_t>(y) * W + x;
    if (off == nullptr) {
      out[p] = s;
      continue;
    }
    const int ox = s.y >= BIG ? 0 : s.y - x;
    const int oy = s.x >= BIG ? 0 : s.x - y;
    off[p] = make_int2(ox, oy);
    has[p] = s.x < BIG && abs(ox) <= radius && abs(oy) <= radius;
  }
}

// One neighbour (dr, dc) of a stride above HALO_STRIDE_MAX, frame-wide:
// a thread a pixel, grid ceil(H W / STEP_THREADS).
__global__ void __launch_bounds__(STEP_THREADS)
flood_step_kernel(const int2* __restrict__ in, int2* __restrict__ out, int H,
                  int W, int dr, int dc) {
  const size_t p = static_cast<size_t>(blockIdx.x) * STEP_THREADS +
                   threadIdx.x;
  if (p >= static_cast<size_t>(H) * W) return;
  const int y = static_cast<int>(p / W), x = static_cast<int>(p % W);
  int2 cur = in[p];
  const int yn = y + dr, xn = x + dc;
  if (yn >= 0 && yn < H && xn >= 0 && xn < W) {
    const int2 cand = in[static_cast<size_t>(yn) * W + xn];
    if (dist2(cand, y, x) < dist2(cur, y, x)) cur = cand;
  }
  out[p] = cur;
}

// Launches flood_tile_kernel<S>. A tile above 48 KiB of shared memory
// (S = 8) needs the opt-in attribute, set once a device.
template <int S>
cudaError_t launch_tile(const int2* in, int2* out, int2* off, bool* has,
                        int H, int W, int radius, cudaStream_t stream) {
  constexpr int bytes =
      (FLOOD_TH + 6 * S) * (FLOOD_TW + 6 * S) * static_cast<int>(sizeof(int2));
  if (bytes > 48 * 1024) {
    static bool opted[64] = {false};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev >= 64 || !opted[dev]) {
      e = cudaFuncSetAttribute(flood_tile_kernel<S>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
      if (e != cudaSuccess) return e;
      if (dev < 64) opted[dev] = true;
    }
  }
  const dim3 grid((W + FLOOD_TW - 1) / FLOOD_TW,
                  (H + FLOOD_TH - 1) / FLOOD_TH);
  flood_tile_kernel<S><<<grid, FLOOD_THREADS, bytes, stream>>>(
      in, out, off, has, H, W, radius);
  return cudaGetLastError();
}

cudaError_t launch_stride(int s, const int2* in, int2* out, int2* off,
                          bool* has, int H, int W, int radius,
                          cudaStream_t stream) {
  switch (s) {
    case 1: return launch_tile<1>(in, out, off, has, H, W, radius, stream);
    case 2: return launch_tile<2>(in, out, off, has, H, W, radius, stream);
    case 4: return launch_tile<4>(in, out, off, has, H, W, radius, stream);
    case 8: return launch_tile<8>(in, out, off, has, H, W, radius, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// src [H, W] uint8 -> edge [H, W] bool, normal and subpix [H, W, 2]
// float32, off [H, W, 2] int32, has [H, W] bool; seed_a and seed_b are
// [H, W, 2] int32 scratch (the flood's ping-pong buffers). thr_sq: the
// weak threshold squared in float32. Strides: the power of two at or above
// radius, halved down to 1 (models/icp.py::_strides). 1 <= H, W < BIG,
// radius <= BIG. *launches: the kernels launched (1 + one a stride up to
// HALO_STRIDE_MAX, 8 a stride above it).
extern "C" int sbm_icp_field(const void* src, void* edge, void* normal,
                             void* subpix, void* off, void* has, void* seed_a,
                             void* seed_b, int H, int W, float thr_sq,
                             int radius, void* stream, int* launches) {
  *launches = 0;
  if (H < 1 || W < 1 || H >= BIG || W >= BIG || radius > BIG)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  auto* a = static_cast<int2*>(seed_a);
  auto* b = static_cast<int2*>(seed_b);
  const dim3 fgrid((W + FE_TILE - 1) / FE_TILE, (H + FE_TILE - 1) / FE_TILE);
  field_frontend_kernel<<<fgrid, FE_THREADS, 0, st>>>(
      static_cast<const uint8_t*>(src), static_cast<bool*>(edge),
      static_cast<float2*>(normal), static_cast<float2*>(subpix), a, H, W,
      thr_sq);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  *launches = 1;
  int s = 1;
  while (s < radius) s *= 2;
  const unsigned steps = static_cast<unsigned>(
      (static_cast<size_t>(H) * W + STEP_THREADS - 1) / STEP_THREADS);
  for (; s >= 1; s /= 2) {
    if (s > HALO_STRIDE_MAX) {
      for (int q = 0; q < 9; ++q) {
        if (q == 4) continue;
        flood_step_kernel<<<steps, STEP_THREADS, 0, st>>>(
            a, b, H, W, (q / 3 - 1) * s, (q % 3 - 1) * s);
        e = cudaGetLastError();
        if (e != cudaSuccess) return static_cast<int>(e);
        ++*launches;
        int2* t = a;
        a = b;
        b = t;
      }
      continue;
    }
    const bool last = s == 1;
    e = launch_stride(s, a, b, last ? static_cast<int2*>(off) : nullptr,
                      last ? static_cast<bool*>(has) : nullptr, H, W, radius,
                      st);
    if (e != cudaSuccess) return static_cast<int>(e);
    ++*launches;
    int2* t = a;
    a = b;
    b = t;
  }
  return 0;
}
