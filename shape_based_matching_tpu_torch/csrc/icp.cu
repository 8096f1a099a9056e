// The ICP layer's kernel: every sim2 point-to-plane step of
// models/icp.py::icp_refine_points for every candidate, in one launch.
//
// icp_kernel: a block a candidate c, state s = (a, b, tx, ty) from (1, 0,
// origin). A step moves each template point p of c to
//   q = (a px - b py + tx, b px + a py + ty),
// rounds q to its pixel (rintf: half to even, as torch.round), follows the
// edge field (off, has; lookups clamp to the frame) to the nearest edge e
// (pixel plus subpixel shift), keeps the point where pt_valid and has hold
// and |q - e|^2 <= r^2, and solves the normal equations
//   (sum_ok M^T M + L I) s' = sum_ok M^T rhs + L s,   L = 1e-3,
// with M = (nx px + ny py, -nx py + ny px, nx, ny), rhs = nx ex + ny ey;
// a candidate with fewer than min_inliers inliers keeps its state. After
// the last step: rmse = sqrt(sum_ok (M s' - rhs)^2 / max(n_in, 1)) over the
// last step's correspondences, inliers = n_in, valid = n_in >= min_inliers,
// dtheta = rad2deg(atan2(b, a)), dscale = hypot(a, b).
// Plain twin: models/icp.py::icp_refine_points_plain.
//
// Exactness: every per-point value (q, the pixels, the lookups, the radius
// test, M, rhs) takes the twin's operations in the twin's order, one IEEE
// rounding each (the intrinsics below are never contracted), so the
// correspondences of an equal state are the twin's. The sums and the solve
// take the arithmetic of the cuBLAS kernels that the twin's bmm and
// linalg.solve_ex run on this card for a batch of candidates (read off
// their outputs, bit for bit, at 6 to 64 candidates of 40 to 300 points):
//   A = Mw^T M: sgemm, one fused multiply-add a point, in point order;
//   v = Mw^T rhs: gemv, 32 lanes, lane l the runs of 4 points 4l + 128i
//       in order, then a shfl_down fold at 16, 8, 4, 2, 1;
//   the solve: getrf (the first row of largest |pivot|, the column scaled
//       by the pivot's reciprocal, one fused multiply-add each trailing
//       entry) and getrs (the row swaps in order, forward substitution,
//       back substitution dividing by the diagonal), fused multiply-adds.
// So on such a batch the poses, inliers and valid flags are the twin's on
// the card bit for bit; on one candidate (cuBLAS takes other kernels) they
// differ by float32 rounding. rmse sums in this kernel's own order.
//
// What bounds it: nothing on this card. At the benchmark's shapes (32
// candidates of about 130 points, 12 steps) a step reads about 12 KB from
// a field that stays in L2, and its arithmetic is a few hundred thousand
// flops; the time is each step's dependent chain: two gathers, A's running
// sums (one fused multiply-add a point, in order), a serial 4x4 solve and
// a broadcast. The twin queues ~79 torch operations a step, each a launch
// of a few microseconds. Design:
// * A block of ICP_THREADS threads owns one candidate for every step. The
//   points pass in chunks of ICP_THREADS, a point a thread, so any N >= 0
//   works without a second path: each thread stages its point's M, M * w
//   and rhs in shared memory, then warp i folds v's entry i (a chunk is
//   one run of GEMV_RUN points on each of its GEMV_LANES lanes), and
//   threads 0..9 carry A's 10 distinct entries on.
// * Thread 0 adds the anchor, solves, applies the min_inliers choice and
//   broadcasts the state through shared memory.
// * rmse needs the last step's correspondences and the new state: the
//   last step's points are visited once more after the loop.
// tests/torch_icp_replay.py replays this arithmetic in NumPy from the
// constants below.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int ICP_THREADS = 128;                  // threads a candidate
constexpr int ICP_WARP = 32;
constexpr int ICP_WARPS = ICP_THREADS / ICP_WARP;
constexpr int ICP_SUMS = 14;  // A's 10 distinct entries, then v's 4
constexpr int GEMV_LANES = 32;  // v's partial sums, one a lane
constexpr int GEMV_RUN = 4;     // consecutive points a lane takes at once
static_assert(GEMV_LANES * GEMV_RUN == ICP_THREADS,
              "a chunk of points is one run on every lane");
static_assert(GEMV_LANES == ICP_WARP && ICP_WARPS == 4,
              "one warp for each entry of v");
constexpr float LAMBDA = 1e-3f;                   // models/icp.py LAMBDA
constexpr float RAD2DEG = 57.295779513082320876f;  // torch.rad2deg's factor

// A's distinct entries in ICP_SUMS order: (0,0) (0,1) (0,2) (0,3) (1,1)
// (1,2) (1,3) (2,2) (2,3) (3,3)
__device__ constexpr int sum_row(int e) {
  return e < 4 ? 0 : e < 7 ? 1 : e < 9 ? 2 : 3;
}
__device__ constexpr int sum_col(int e) {
  return e < 4 ? e : e < 7 ? e - 3 : e < 9 ? e - 5 : 3;
}

struct Corr {
  float m[4];  // the plane row M
  float rhs;
  bool ok;     // an inlier
};

// The twin's flat(yy, xx): int32 clamps, then y * W + x.
__device__ __forceinline__ int flat(int y, int x, int H, int W) {
  return min(max(y, 0), H - 1) * W + min(max(x, 0), W - 1);
}

// int32 addition that wraps as torch's does.
__device__ __forceinline__ int add_wrap(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) +
                          static_cast<uint32_t>(b));
}

// One point's correspondence under state s, in the twin's operation order.
__device__ __forceinline__ Corr correspond(
    const float s[4], float px, float py, bool live,
    const int2* __restrict__ off, const float2* __restrict__ normal,
    const uint8_t* __restrict__ has, const float2* __restrict__ subpix,
    int H, int W, float r2) {
  const float qx =
      __fadd_rn(__fsub_rn(__fmul_rn(s[0], px), __fmul_rn(s[1], py)), s[2]);
  const float qy =
      __fadd_rn(__fadd_rn(__fmul_rn(s[1], px), __fmul_rn(s[0], py)), s[3]);
  const int ix = static_cast<int>(rintf(qx));
  const int iy = static_cast<int>(rintf(qy));
  const int i = flat(iy, ix, H, W);
  const int2 o = __ldg(off + i);
  const int ei = add_wrap(ix, o.x), ej = add_wrap(iy, o.y);
  const int j = flat(ej, ei, H, W);
  const float2 n = __ldg(normal + j);
  const float2 sp = __ldg(subpix + j);
  const float ex = __fadd_rn(static_cast<float>(ei), sp.x);
  const float ey = __fadd_rn(static_cast<float>(ej), sp.y);
  const float ddx = __fsub_rn(qx, ex), ddy = __fsub_rn(qy, ey);
  Corr c;
  c.ok = live && __ldg(has + i) != 0 &&
         __fadd_rn(__fmul_rn(ddx, ddx), __fmul_rn(ddy, ddy)) <= r2;
  c.m[0] = __fadd_rn(__fmul_rn(n.x, px), __fmul_rn(n.y, py));
  c.m[1] = __fadd_rn(__fmul_rn(-n.x, py), __fmul_rn(n.y, px));
  c.m[2] = n.x;
  c.m[3] = n.y;
  c.rhs = __fadd_rn(__fmul_rn(n.x, ex), __fmul_rn(n.y, ey));
  return c;
}

// The warp's sum of v lands in lane 0 (shfl_down at 16, 8, 4, 2, 1).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int d = ICP_WARP / 2; d >= 1; d /= 2)
    v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, d));
  return v;
}

__device__ __forceinline__ int warp_count(int n) {
#pragma unroll
  for (int d = ICP_WARP / 2; d >= 1; d /= 2)
    n += __shfl_down_sync(0xffffffffu, n, d);
  return n;
}

// Rows j and p > j of m swapped, p found among the compile-time rows r, so
// that m stays in registers.
__device__ __forceinline__ void swap_rows(float (&m)[4][4], int j, int p) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    if (r > j && r == p) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float t = m[j][k];
        m[j][k] = m[r][k];
        m[r][k] = t;
      }
    }
  }
}

// A x = b as cuBLAS's batched getrf and getrs take it: at column j the
// first row of largest |a| pivots, the column below is scaled by the
// pivot's reciprocal, the trailing rows take one fused multiply-add each;
// then the row swaps on b in order, forward substitution with the unit
// lower factor, and back substitution dividing by each diagonal entry.
__device__ __forceinline__ void solve4(float (&m)[4][4], float (&b)[4]) {
  int piv[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    int p = j;
    float best = fabsf(m[j][j]);
#pragma unroll
    for (int r = j + 1; r < 4; ++r) {
      if (fabsf(m[r][j]) > best) {
        best = fabsf(m[r][j]);
        p = r;
      }
    }
    piv[j] = p;
    swap_rows(m, j, p);
    const float rc = __frcp_rn(m[j][j]);
#pragma unroll
    for (int i = j + 1; i < 4; ++i) m[i][j] = __fmul_rn(m[i][j], rc);
#pragma unroll
    for (int i = j + 1; i < 4; ++i) {
#pragma unroll
      for (int k = j + 1; k < 4; ++k)
        m[i][k] = __fmaf_rn(-m[i][j], m[j][k], m[i][k]);
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int r = j + 1; r < 4; ++r) {
      if (r == piv[j]) {
        const float t = b[j];
        b[j] = b[r];
        b[r] = t;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int i = j + 1; i < 4; ++i) b[i] = __fmaf_rn(-m[i][j], b[j], b[i]);
  }
#pragma unroll
  for (int j = 3; j >= 0; --j) {
    b[j] = __fdiv_rn(b[j], m[j][j]);
#pragma unroll
    for (int i = 0; i < j; ++i) b[i] = __fmaf_rn(-m[i][j], b[j], b[i]);
  }
}

__global__ void __launch_bounds__(ICP_THREADS)
    icp_kernel(const int2* __restrict__ off,
               const float2* __restrict__ normal,
               const uint8_t* __restrict__ has,
               const float2* __restrict__ subpix,
               const float2* __restrict__ pts,
               const float2* __restrict__ origins,
               const uint8_t* __restrict__ pt_valid, float* __restrict__ out,
               int* __restrict__ inliers, uint8_t* __restrict__ valid, int C,
               int N, int H, int W, int iters, float r2, int min_inliers) {
  __shared__ float s_m[4][ICP_THREADS];   // a chunk's plane rows M
  __shared__ float s_mw[4][ICP_THREADS];  // and M * w (w = 1 for inliers)
  __shared__ float s_rhs[ICP_THREADS];
  __shared__ float s_sum[ICP_SUMS];       // A's 10 entries, then v's 4
  __shared__ float red[ICP_WARPS];
  __shared__ int red_n[ICP_WARPS];
  __shared__ float s_state[4];
  __shared__ int s_nin;
  const int c = blockIdx.x, t = threadIdx.x;
  const int lane = t % ICP_WARP, warp = t / ICP_WARP;
  const float2* p = pts + static_cast<long long>(c) * N;
  const uint8_t* pv = pt_valid + static_cast<long long>(c) * N;
  const float2 org = __ldg(origins + c);
  float s[4] = {1.0f, 0.0f, org.x, org.y};
  float prev[4] = {s[0], s[1], s[2], s[3]};
  int n_in = 0;
  for (int it = 0; it < iters; ++it) {
    float a_sum = 0.0f;  // thread t < 10: A's entry t
    float v_sum = 0.0f;  // v's entry `warp`, this lane's runs
    int cnt = 0;
    for (int base = 0; base < N; base += ICP_THREADS) {
      const int len = min(ICP_THREADS, N - base);
      if (t < len) {
        const float2 pt = __ldg(p + base + t);
        const Corr q = correspond(s, pt.x, pt.y, __ldg(pv + base + t) != 0,
                                  off, normal, has, subpix, H, W, r2);
        const float w = q.ok ? 1.0f : 0.0f;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          s_m[k][t] = q.m[k];
          s_mw[k][t] = __fmul_rn(q.m[k], w);
        }
        s_rhs[t] = q.rhs;
        cnt += q.ok;
      }
      __syncthreads();
      // v: lane l takes the chunk's points GEMV_RUN * l onward
#pragma unroll
      for (int j = 0; j < GEMV_RUN; ++j) {
        const int k = lane * GEMV_RUN + j;
        if (k < len) v_sum = __fmaf_rn(s_mw[warp][k], s_rhs[k], v_sum);
      }
      // A: one running sum an entry, point after point
      if (t < 10) {
        const float* mw = s_mw[sum_row(t)];
        const float* m = s_m[sum_col(t)];
        for (int k = 0; k < len; ++k) a_sum = __fmaf_rn(mw[k], m[k], a_sum);
      }
      __syncthreads();
    }
    v_sum = warp_sum(v_sum);
    cnt = warp_count(cnt);
    if (lane == 0) {
      s_sum[10 + warp] = v_sum;
      red_n[warp] = cnt;
    }
    if (t < 10) s_sum[t] = a_sum;
    __syncthreads();
    if (t == 0) {
      int n_tot = red_n[0];
      for (int w = 1; w < ICP_WARPS; ++w) n_tot += red_n[w];
      float m[4][4], x[4];
#pragma unroll
      for (int e = 0; e < 10; ++e) {
        const int r = sum_row(e), k = sum_col(e);
        const float a = __fadd_rn(s_sum[e], r == k ? LAMBDA : 0.0f);
        m[r][k] = a;
        m[k][r] = a;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k)
        x[k] = __fadd_rn(s_sum[10 + k], __fmul_rn(LAMBDA, s[k]));
      solve4(m, x);
      const bool take = n_tot >= min_inliers;
#pragma unroll
      for (int k = 0; k < 4; ++k) s_state[k] = take ? x[k] : s[k];
      s_nin = n_tot;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      prev[k] = s[k];
      s[k] = s_state[k];
    }
    n_in = s_nin;
  }
  // rmse: the last step's correspondences (under prev) against the new
  // state; zero when no step ran
  float rr = 0.0f;
  if (iters > 0) {
    for (int n = t; n < N; n += ICP_THREADS) {
      const float2 pt = __ldg(p + n);
      const Corr q = correspond(prev, pt.x, pt.y, __ldg(pv + n) != 0, off,
                                normal, has, subpix, H, W, r2);
      float dot = __fmul_rn(q.m[0], s[0]);
#pragma unroll
      for (int k = 1; k < 4; ++k) dot = __fadd_rn(dot, __fmul_rn(q.m[k], s[k]));
      const float r = __fmul_rn(__fsub_rn(dot, q.rhs), q.ok ? 1.0f : 0.0f);
      rr = __fadd_rn(rr, __fmul_rn(r, r));
    }
    rr = warp_sum(rr);
    if (lane == 0) red[warp] = rr;
    __syncthreads();
  }
  if (t == 0) {
    float sum = 0.0f;
    if (iters > 0) {
      sum = red[0];
      for (int w = 1; w < ICP_WARPS; ++w) sum = __fadd_rn(sum, red[w]);
    }
    out[c] = __fmul_rn(atan2f(s[1], s[0]), RAD2DEG);
    out[C + c] = hypotf(s[0], s[1]);
    out[2 * C + c] = s[2];
    out[3 * C + c] = s[3];
    out[4 * C + c] = __fsqrt_rn(
        __fdiv_rn(sum, static_cast<float>(n_in > 1 ? n_in : 1)));
    inliers[c] = n_in;
    valid[c] = n_in >= min_inliers;
  }
}

}  // namespace

// off [H, W, 2] int32, normal [H, W, 2] float32, has [H, W] bool, subpix
// [H, W, 2] float32, pts [C, N, 2] float32, origins [C, 2] float32,
// pt_valid [C, N] bool -> out [5, C] float32 (dtheta_deg, dscale, tx, ty,
// rmse), inliers [C] int32, valid [C] bool; r2 = float(radius^2).
extern "C" int sbm_icp_steps(const void* off, const void* normal,
                             const void* has, const void* subpix,
                             const void* pts, const void* origins,
                             const void* pt_valid, void* out, void* inliers,
                             void* valid, int C, int N, int H, int W,
                             int iters, float r2, int min_inliers,
                             void* stream) {
  if (C < 1 || N < 0 || H < 1 || W < 1 || iters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  icp_kernel<<<C, ICP_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int2*>(off), static_cast<const float2*>(normal),
      static_cast<const uint8_t*>(has), static_cast<const float2*>(subpix),
      static_cast<const float2*>(pts), static_cast<const float2*>(origins),
      static_cast<const uint8_t*>(pt_valid), static_cast<float*>(out),
      static_cast<int*>(inliers), static_cast<uint8_t*>(valid), C, N, H, W,
      iters, r2, min_inliers);
  return static_cast<int>(cudaGetLastError());
}
