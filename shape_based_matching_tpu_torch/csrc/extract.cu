// Counted candidate extraction: the first C candidates of each of B frames
// from the coarse scores S [B, K, M] int32 (template-indexed rows, as
// coarse.cu and chain.cu write them) and the per-template live counts
// cnt [B, K] (cells j < pos[k] with S >= rmin[k]). The O(B*K) prefix runs
// in torch before the launch: bcnt = cnt + qcnt (qcnt = M - clip(pos, 0, M)
// cells at score 0 where rmin <= 0, the reference's zero-initialized
// similarity Mat, line2Dup.cpp:1190-1216), incl = cumsum(bcnt) and
// excl = incl - bcnt. Slot i of frame b belongs to the template k with
// excl <= i < incl; its rank r = i - excl picks
//   r < cnt:   the r-th live cell j of the row (j ascending), raw S[j];
//   r >= cnt:  the quirk cell j = clip(pos, 0, M) + (r - cnt), raw 0;
// and the slot's results are k, x = (j % W) * T + off, y = (j / W) * T +
// off, score = f32(raw * 100) / t4n[k] and valid = i < incl (so i <
// n_above). Slots at or past n_above belong to template K-1 under the same
// formulas (r >= its count: quirk cells, invalid), as the plain twin's
// clamped searchsorted gives them. A rank past the live cells that the row
// really holds (a count that overstates it) reads cell M-1, as the twin's
// clamped search does.
//
// Replaces the XLA extraction of the TPU package
// (shape_based_matching_tpu/ops/similarity.py::_extract_counted_core, the
// word-row gather at :800; no Pallas kernel). Plain twin:
// ops/cuda/extract.py::extract_counted_plain, which gathers a whole score
// row per slot ([B, C, M] int32 twice and a bool of the same shape); this
// kernel needs no memory beyond its [B, C] outputs.
//
// Bound on the card: the bytes of the S rows that must be read (each
// template's row up to its last taken live cell) and the 17 bytes of
// results a slot; a stream compaction, so bytes bound it. Design: one
// 256-thread block per (template, frame); a block whose slot range misses
// [0, C) returns at once. The block walks its row once in chunks of CHUNK
// cells, a thread owning 4 consecutive cells (one 16-byte load where the
// row is aligned), flags S >= rmin below pos, ranks the flags with one
// ballot per cell of a thread and popc over the lower lanes, the warps'
// totals through shared memory, and writes slot excl + rank while the rank
// is below min(cnt, C - excl); it stops when that many are written. Quirk
// and past-the-end slots are filled in closed form by the same block. The
// score rounds as the twin's (the build passes --fmad=false, no fast math).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CELLS = 4;                 // consecutive cells per thread
constexpr int CHUNK = THREADS * CELLS;   // cells per block step
static_assert(CELLS == 4, "a thread's cells are one int4");

struct Out {
  int* k;
  int* x;
  int* y;
  float* sc;
  uint8_t* valid;
};

__device__ __forceinline__ void put(const Out& o, long long at, int slot,
                                    int k, int j, int raw, float t4n, int T,
                                    int W, int incl) {
  const int off = T / 2 + (T % 2 - 1);
  o.k[at] = k;
  o.x[at] = (j % W) * T + off;
  o.y[at] = (j / W) * T + off;
  o.sc[at] = __fdiv_rn(__int2float_rn(raw * 100), t4n);
  o.valid[at] = slot < incl;
}

__global__ void __launch_bounds__(THREADS)
extract_kernel(const int* __restrict__ S, const int* __restrict__ cnt,
               const int* __restrict__ excl, const int* __restrict__ incl,
               const int* __restrict__ pos, const int* __restrict__ rmin,
               const float* __restrict__ t4n, Out o, int K, int M, int C,
               int T, int W, int vec) {
  const int k = blockIdx.x;
  const long long bk = static_cast<long long>(blockIdx.y) * K + k;
  const int e = __ldg(excl + bk);
  const int hi = __ldg(incl + bk);
  // template K-1 also owns the slots past n_above
  const int need = (k == K - 1 ? C : min(hi, C)) - e;
  if (e >= C || need <= 0) return;
  const int lcnt = __ldg(cnt + bk);
  const int pc = min(max(__ldg(pos + k), 0), M);
  const int rm = __ldg(rmin + k);
  const float tn = __ldg(t4n + k);
  const int target = min(lcnt, need);  // live slots of this block
  const long long at0 = static_cast<long long>(blockIdx.y) * C + e;
  const int* row = S + bk * M;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned below_mask = (1u << lane) - 1u;
  __shared__ int warp_total[WARPS];

  int found = 0;  // live cells ranked so far, the same in every thread
  for (int j0 = 0; found < target && j0 < pc; j0 += CHUNK) {
    const int j = j0 + CELLS * threadIdx.x;
    int v[CELLS] = {0, 0, 0, 0};
    if (vec) {  // M % 4 == 0 and an aligned S: the 4 cells lie in the row
      if (j < pc) {
        const int4 w = __ldg(reinterpret_cast<const int4*>(row + j));
        v[0] = w.x;
        v[1] = w.y;
        v[2] = w.z;
        v[3] = w.w;
      }
    } else {
#pragma unroll
      for (int q = 0; q < CELLS; ++q)
        if (j + q < pc) v[q] = __ldg(row + j + q);
    }
    bool f[CELLS];
    int below = 0, total = 0;
#pragma unroll
    for (int q = 0; q < CELLS; ++q) {
      f[q] = j + q < pc && v[q] >= rm;
      const unsigned m = __ballot_sync(0xffffffffu, f[q]);
      below += __popc(m & below_mask);
      total += __popc(m);
    }
    if (lane == 0) warp_total[warp] = total;
    __syncthreads();
    int rank = found + below;
    int chunk_total = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const int t = warp_total[w];
      rank += w < warp ? t : 0;
      chunk_total += t;
    }
    __syncthreads();  // warp_total is rewritten by the next chunk
#pragma unroll
    for (int q = 0; q < CELLS; ++q) {
      if (f[q]) {
        if (rank < target)
          put(o, at0 + rank, e + rank, k, j + q, v[q], tn, T, W, hi);
        ++rank;
      }
    }
    found += chunk_total;
  }
  // ranks the row does not hold (a count above its live cells): cell M-1
  if (found < target) {
    const int raw = __ldg(row + M - 1);
    for (int r = found + threadIdx.x; r < target; r += THREADS)
      put(o, at0 + r, e + r, k, M - 1, raw, tn, T, W, hi);
  }
  // quirk cells and the slots past n_above: closed form, score 0
  for (int r = max(lcnt, 0) + threadIdx.x; r < need; r += THREADS)
    put(o, at0 + r, e + r, k, pc + (r - lcnt), 0, tn, T, W, hi);
}

}  // namespace

extern "C" int sbm_extract_counted(
    const void* S, const void* cnt, const void* excl, const void* incl,
    const void* pos, const void* rmin, const void* t4n, void* k_out,
    void* x_out, void* y_out, void* sc_out, void* valid_out, int B, int K,
    int M, int C, int T, int W, int vec, void* stream) {
  const Out o{static_cast<int*>(k_out), static_cast<int*>(x_out),
              static_cast<int*>(y_out), static_cast<float*>(sc_out),
              static_cast<uint8_t*>(valid_out)};
  const dim3 grid(K, B);
  extract_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(S), static_cast<const int*>(cnt),
      static_cast<const int*>(excl), static_cast<const int*>(incl),
      static_cast<const int*>(pos), static_cast<const int*>(rmin),
      static_cast<const float*>(t4n), o, K, M, C, T, W, vec);
  return static_cast<int>(cudaGetLastError());
}
