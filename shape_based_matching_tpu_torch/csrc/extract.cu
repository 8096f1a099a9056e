// Counted candidate extraction: the first C candidates of each of B frames
// from the coarse scores S [B, K, M] int32 (template-indexed rows, as
// coarse.cu and chain.cu write them) and the per-template live counts
// cnt [B, K] (cells j < pos[k] with S >= rmin[k]). Per frame, bcnt = cnt +
// qcnt (qcnt = M - clip(pos, 0, M) cells at score 0 where rmin <= 0, the
// reference's zero-initialized similarity Mat, line2Dup.cpp:1190-1216),
// incl = its int32 inclusive prefix over the templates and excl = incl -
// bcnt. Slot i of frame b belongs to the template k with excl <= i < incl;
// its rank r = i - excl picks
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
// row per slot; these kernels need no memory beyond their [B, C] outputs
// and a work list of 32 bytes a template.
//
// Bound on the card: the bytes of the S rows that must be read (each
// template's row up to its last taken live cell) and the 17 bytes of
// results a slot; a stream compaction, so bytes bound it. Two launches:
//
// 1. prefix_kernel, one 1024-thread block per frame: bcnt, its exclusive
//    and inclusive prefix in tiles of P_TILE templates (two block scans a
//    tile and a carried total; the next tile's loads are issued before
//    this tile's scans), n_above, and the WORK LIST: the templates whose
//    slot range meets [0, C) (template K-1 whenever its range starts
//    below C: it owns the slots past n_above), at most min(K, C) records
//    of (k, excl, incl, cnt, clip(pos), rmin, t4n bits). It also zeroes
//    the frame's ticket and, where rows have more than one segment, the
//    listed templates' look-back words. No torch op runs before the
//    extraction.
// 2. extract_kernel, its grid sized by the list, not by K:
//    * Rows of one segment (M <= SEG: every 1024^2 path) wait on nothing:
//      block (x, b) walks frame b's listed template x, and blocks past the
//      list's length exit without reading S.
//    * Segments. Longer rows (the 4096^2 frame's 8) take a persistent
//      grid (the blocks the card holds at once, fewer where the list is
//      shorter). A listed template's row is cut into segments of SEG
//      cells; a block takes one (template, segment) at a time from an
//      atomic ticket per frame, segment-major (every template's segment 0,
//      then every segment 1, ...), so the segments of one long row run on
//      several SMs at once and every segment a block waits on holds an
//      earlier ticket, taken by a block already running (a block takes its
//      next ticket while it works on the current one, never two ahead).
//      Blocks start on different frames of a batch.
//    * Decoupled look-back. Before it reads, a block peeks at the word of
//      its row's previous segment; where that holds the inclusive live
//      count (INC), the block knows its own exclusive count, and reads
//      nothing if that already reaches the row's target min(cnt, slots it
//      owns below C): the early stop, to the segment, of every row whose
//      previous segment finished first (on a busy card, nearly all).
//      Otherwise it reads its segment, publishes its own count (AGG), and
//      sums the words back to the nearest INC. A segment that skipped
//      publishes its predecessor's count, which is at least the target,
//      so every later segment of the row skips too. The outputs are the
//      same in any schedule: each slot is written once, by the block whose
//      segment holds its cell. A word left unset for seconds traps
//      instead of hanging the card.
//    * Bytes in flight: several unrolled 16-byte loads a thread. A thread
//      issues LOADS int4 loads (4 cells each, CHUNK cells a load across
//      the block) before it ranks any cell: 32 KB a block in flight,
//      BLOCKS_PER_SM blocks an SM, where the card needs about 18 KB an SM
//      (3.35 TB/s x ~0.7 us over 132 SMs). The loaded scores are dropped
//      once flagged; the few live cells are read again (L1 or L2) when
//      written, which keeps the registers to 64 a thread. The next
//      ticket's atomic and the peek are issued beside the record's loads.
//      Rows that are not 16-byte aligned (M % 4 != 0 or an unaligned S)
//      take scalar loads, the same count in flight.
//    * Ranking: one ballot per cell of a thread and popc over the lower
//      lanes; the warps' totals of all LOADS chunks go through shared
//      memory behind ONE barrier a segment.
//    Quirk and past-the-end slots are filled in closed form, THREADS-slot
//    groups dealt over the row's segments; the last segment writes the
//    ranks that an overstated count leaves (cell M-1). The score rounds as
//    the twin's (the build passes --fmad=false, no fast math).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CELLS = 4;                 // consecutive cells of one int4
constexpr int CHUNK = THREADS * CELLS;   // cells of one load across a block
constexpr int LOADS = 8;                 // int4 loads a thread issues at once
constexpr int SEG = CHUNK * LOADS;       // cells of one segment (one ticket)
constexpr int BLOCKS_PER_SM = 4;         // registers: at most 64 a thread
constexpr int P_THREADS = 1024;          // prefix kernel: a block per frame
constexpr int P_WARPS = P_THREADS / 32;
constexpr int P_ITEMS = 4;               // templates a thread per tile
constexpr int P_TILE = P_THREADS * P_ITEMS;
constexpr int REC = 8;                   // ints of one work record
static_assert(CELLS == 4, "a thread's cells are one int4");
static_assert(LOADS * CELLS <= 32, "a thread's flags fit one word");
static_assert(P_WARPS == 32, "one warp scans the warps' totals");

// look-back word of a (listed template, segment): 0 until published, then
// a live count: AGG the segment's own, INC with every segment before it
constexpr unsigned AGG = 1u << 30;
constexpr unsigned INC = 2u << 30;
constexpr unsigned VAL = AGG - 1u;

// exclusive prefix of v over the block (P_THREADS threads) and the block's
// total; `buf` (P_WARPS words) must not be read by the block again until a
// later barrier
__device__ __forceinline__ unsigned block_excl(unsigned v, unsigned* buf,
                                               unsigned& total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) buf[warp] = x;
  __syncthreads();
  if (warp == 0) {
    unsigned w = buf[lane];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned y = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += y;
    }
    buf[lane] = w;
  }
  __syncthreads();
  total = buf[P_WARPS - 1];
  return x - v + (warp ? buf[warp - 1] : 0u);
}

__global__ void __launch_bounds__(P_THREADS)
prefix_kernel(const int* __restrict__ cnt, const int* __restrict__ pos,
              const int* __restrict__ rmin, const float* __restrict__ t4n,
              int* __restrict__ n_above, int* __restrict__ work,
              int* __restrict__ meta, unsigned* __restrict__ status, int K,
              int M, int C, int L) {
  __shared__ unsigned sum_buf[P_WARPS];
  __shared__ unsigned list_buf[P_WARPS];
  const int b = blockIdx.x;
  const int* crow = cnt + static_cast<long long>(b) * K;
  int* wrow = work + static_cast<long long>(b) * K * REC;
  unsigned* srow = status + static_cast<long long>(b) * L * K;
  unsigned carry = 0;   // candidates of the tiles before (int32 wrap)
  unsigned listed = 0;  // work records of the tiles before
  // a tile's inputs; the next tile's loads are issued before this one's
  // scans
  int lc[P_ITEMS], pc[P_ITEMS], rm[P_ITEMS];
  auto load = [&](int k0, int* c, int* p, int* r) {
#pragma unroll
    for (int q = 0; q < P_ITEMS; ++q) {
      const int k = k0 + P_ITEMS * threadIdx.x + q;
      c[q] = k < K ? __ldg(crow + k) : 0;
      p[q] = k < K ? min(max(__ldg(pos + k), 0), M) : 0;
      r[q] = k < K ? __ldg(rmin + k) : 0;
    }
  };
  load(0, lc, pc, rm);
  for (int k0 = 0; k0 < K; k0 += P_TILE) {
    const int kb = k0 + P_ITEMS * threadIdx.x;
    unsigned bc[P_ITEMS], mine = 0;
#pragma unroll
    for (int q = 0; q < P_ITEMS; ++q) {
      bc[q] = kb + q < K ? static_cast<unsigned>(lc[q]) +
                               (rm[q] <= 0 ? static_cast<unsigned>(M - pc[q])
                                           : 0u)
                         : 0u;
      mine += bc[q];
    }
    int nlc[P_ITEMS], npc[P_ITEMS], nrm[P_ITEMS];
    load(k0 + P_TILE, nlc, npc, nrm);
    unsigned tile;
    unsigned e = carry + block_excl(mine, sum_buf, tile);
    carry += tile;
    int ex[P_ITEMS], in[P_ITEMS];
    unsigned take = 0;  // bit q: template kb + q is listed
#pragma unroll
    for (int q = 0; q < P_ITEMS; ++q) {
      const int k = kb + q;
      ex[q] = static_cast<int>(e);
      e += bc[q];
      in[q] = static_cast<int>(e);
      if (k < K) {
        if (k == K - 1) n_above[b] = in[q];
        const int need = (k == K - 1 ? C : min(in[q], C)) - ex[q];
        if (ex[q] < C && need > 0) take |= 1u << q;
      }
    }
    unsigned n_tile;
    unsigned at = listed + block_excl(__popc(take), list_buf, n_tile);
    listed += n_tile;
#pragma unroll
    for (int q = 0; q < P_ITEMS; ++q) {
      if (!(take >> q & 1u)) continue;
      const int k = kb + q;
      int4* r = reinterpret_cast<int4*>(wrow + static_cast<long long>(at) *
                                                   REC);
      r[0] = make_int4(k, ex[q], in[q], lc[q]);
      r[1] = make_int4(pc[q], rm[q], __float_as_int(__ldg(t4n + k)), 0);
      ++at;
    }
#pragma unroll
    for (int q = 0; q < P_ITEMS; ++q) {
      lc[q] = nlc[q];
      pc[q] = npc[q];
      rm[q] = nrm[q];
    }
  }
  // the look-back words of the listed templates (rows of one segment read
  // none)
  if (L > 1)
    for (long long x = threadIdx.x; x < static_cast<long long>(listed) * L;
         x += P_THREADS)
      srow[x / listed * K + x % listed] = 0u;
  if (threadIdx.x == 0) {
    meta[2 * b] = static_cast<int>(listed);  // work records
    meta[2 * b + 1] = 0;                     // the extraction's ticket
  }
}

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

__device__ __forceinline__ unsigned peek(const unsigned* p) {
  return *reinterpret_cast<const volatile unsigned*>(p);
}

__device__ __forceinline__ void publish(unsigned* p, unsigned v) {
  *reinterpret_cast<volatile unsigned*>(p) = v;
}

// the frame's next ticket, or n once they are all taken
__device__ __forceinline__ int grab(int* ticket, int n) {
  return *reinterpret_cast<volatile int*>(ticket) < n ? atomicAdd(ticket, 1)
                                                      : n;
}

// a word that stays unset longer than any predecessor takes (seconds) is a
// fault: trap instead of hanging
__device__ __forceinline__ unsigned wait_word(const unsigned* p) {
  unsigned w;
  for (unsigned spins = 0; (w = peek(p)) == 0u; ++spins) {
    if (spins > (1u << 25)) __trap();
    __nanosleep(32);
  }
  return w;
}

__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
extract_kernel(const int* __restrict__ S, const int* __restrict__ work,
               int* meta, unsigned* status, Out o, int B, int K, int M,
               int C, int T, int W, int L, int vec) {
  __shared__ int s_ticket[2];
  __shared__ int s_excl;
  __shared__ int s_wt[LOADS][WARPS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned below_mask = (1u << lane) - 1u;
  // rows of one segment wait on nothing: block (x, b) takes record x of
  // frame b, no ticket (L == 1, see the launch)
  const bool fixed = L == 1;
  int par = 0;  // s_ticket alternates, so one barrier a ticket suffices
  for (int f0 = 0; f0 < (fixed ? 1 : B); ++f0) {
    // blocks start on every frame
    const int b = fixed ? blockIdx.y : (blockIdx.x + f0) % B;
    const int nw = meta[2 * b];
    const int n = nw * L;  // tickets of the frame, segment-major
    int* ticket = meta + 2 * b + 1;
    if (threadIdx.x == 0)
      s_ticket[par] = fixed ? blockIdx.x : grab(ticket, n);
    for (;;) {
      __syncthreads();
      const int t = s_ticket[par];
      par ^= 1;
      if (t >= n) break;
      // the next ticket, taken now and stored last: its atomic overlaps
      // this segment's loads
      const int next = threadIdx.x != 0 ? 0 : fixed ? n : grab(ticket, n);
      const int s = t / nw;  // segment
      const int i = t - s * nw;
      unsigned* word = status + (static_cast<long long>(b) * L + s) * K + i;
      unsigned prev = INC;  // segment 0: no live cell before it
      if (threadIdx.x == 0 && s > 0) prev = peek(word - K);
      const int* rec = work + (static_cast<long long>(b) * K + i) * REC;
      const int4 r0 = __ldg(reinterpret_cast<const int4*>(rec));
      const int4 r1 = __ldg(reinterpret_cast<const int4*>(rec) + 1);
      const int k = r0.x, e = r0.y, hi = r0.z, lcnt = r0.w;
      const int pc = r1.x, rm = r1.y;
      const float tn = __int_as_float(r1.z);
      const int nseg = max(1, (pc + SEG - 1) / SEG);
      if (s < nseg) {  // past the row: nothing waits on this segment
        // template K-1 also owns the slots past n_above
        const int need = (k == K - 1 ? C : min(hi, C)) - e;
        const int target = min(lcnt, need);  // live slots of the row
        const long long at0 = static_cast<long long>(b) * C + e;
        const int* row = S + (static_cast<long long>(b) * K + k) * M;

        // quirk cells and the slots past n_above: closed form, score 0
        for (int r = max(lcnt, 0) + s * THREADS + threadIdx.x; r < need;
             r += nseg * THREADS)
          put(o, at0 + r, e + r, k, pc + (r - lcnt), 0, tn, T, W, hi);

        if (threadIdx.x == 0)
          s_excl = (prev & INC) ? static_cast<int>(prev & VAL) : -1;
        __syncthreads();
        int ex = s_excl;  // live cells before the segment, -1 unknown yet
        const bool walk = ex < 0 || ex < target;
        const int lo = s * SEG;
        const int end = min(pc, lo + SEG);
        int below[LOADS];
        unsigned f = 0;  // bit q * CELLS + c: the thread's live cells
        int total = 0;   // live cells of the segment
        if (walk) {
          int v[LOADS][CELLS];
#pragma unroll
          for (int q = 0; q < LOADS; ++q) {
            const int j = lo + q * CHUNK + CELLS * threadIdx.x;
            if (vec) {  // the 4 cells lie in the row, 16-byte aligned
              int4 w = make_int4(0, 0, 0, 0);
              if (j < end) w = __ldg(reinterpret_cast<const int4*>(row + j));
              v[q][0] = w.x;
              v[q][1] = w.y;
              v[q][2] = w.z;
              v[q][3] = w.w;
            } else {
#pragma unroll
              for (int c = 0; c < CELLS; ++c)
                v[q][c] = j + c < end ? __ldg(row + j + c) : 0;
            }
          }
#pragma unroll
          for (int q = 0; q < LOADS; ++q) {
            const int j = lo + q * CHUNK + CELLS * threadIdx.x;
            int bl = 0, tot = 0;
#pragma unroll
            for (int c = 0; c < CELLS; ++c) {
              const bool fl = j + c < end && v[q][c] >= rm;
              f |= static_cast<unsigned>(fl) << (q * CELLS + c);
              const unsigned m = __ballot_sync(0xffffffffu, fl);
              bl += __popc(m & below_mask);
              tot += __popc(m);
            }
            below[q] = bl;
            if (lane == 0) s_wt[q][warp] = tot;
          }
          __syncthreads();
#pragma unroll
          for (int q = 0; q < LOADS; ++q)
#pragma unroll
            for (int w = 0; w < WARPS; ++w) total += s_wt[q][w];
        }
        if (ex >= 0) {
          if (threadIdx.x == 0)
            publish(word, INC | static_cast<unsigned>(ex + total));
        } else {
          if (threadIdx.x == 0) {
            publish(word, AGG | static_cast<unsigned>(total));
            unsigned acc = 0;
            for (const unsigned* p = word - K;; p -= K) {
              const unsigned w = wait_word(p);
              acc += w & VAL;
              if (w & INC) break;
            }
            publish(word, INC | (acc + static_cast<unsigned>(total)));
            s_excl = static_cast<int>(acc);
          }
          __syncthreads();
          ex = s_excl;
        }
        if (walk && ex < target) {
          int base = ex;
#pragma unroll
          for (int q = 0; q < LOADS; ++q) {
            int before = 0, chunk = 0;
#pragma unroll
            for (int w = 0; w < WARPS; ++w) {
              const int c = s_wt[q][w];
              before += w < warp ? c : 0;
              chunk += c;
            }
            int rank = base + before + below[q];
            const int j = lo + q * CHUNK + CELLS * threadIdx.x;
#pragma unroll
            for (int c = 0; c < CELLS; ++c) {
              if (f >> (q * CELLS + c) & 1u) {
                // live cells are few: read the score again (L1 or L2)
                if (rank < target)
                  put(o, at0 + rank, e + rank, k, j + c, __ldg(row + j + c),
                      tn, T, W, hi);
                ++rank;
              }
            }
            base += chunk;
          }
        }
        // ranks the row does not hold (a count above its live cells): M-1
        if (s == nseg - 1 && ex + total < target) {
          const int raw = __ldg(row + M - 1);
          for (int r = ex + total + threadIdx.x; r < target; r += THREADS)
            put(o, at0 + r, e + r, k, M - 1, raw, tn, T, W, hi);
        }
      }
      if (threadIdx.x == 0) s_ticket[par] = next;
    }
  }
}

// blocks of extract_kernel the card holds at once, per device
int resident_blocks(int& blocks) {
  static int cached[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 64 && cached[dev] > 0) {
    blocks = cached[dev];
    return 0;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, extract_kernel, THREADS, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  blocks = max(1, per_sm) * max(1, sms);
  if (dev < 64) cached[dev] = blocks;
  return 0;
}

}  // namespace

extern "C" int sbm_extract_prefix(const void* cnt, const void* pos,
                                  const void* rmin, const void* t4n,
                                  void* n_above, void* work, void* meta,
                                  void* status, int B, int K, int M, int C,
                                  int L, void* stream) {
  prefix_kernel<<<B, P_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(cnt), static_cast<const int*>(pos),
      static_cast<const int*>(rmin), static_cast<const float*>(t4n),
      static_cast<int*>(n_above), static_cast<int*>(work),
      static_cast<int*>(meta), static_cast<unsigned*>(status), K, M, C, L);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sbm_extract_counted(
    const void* S, const void* work, void* meta, void* status, void* k_out,
    void* x_out, void* y_out, void* sc_out, void* valid_out, int B, int K,
    int M, int C, int T, int W, int L, int vec, void* stream) {
  int blocks = 0;
  const int err = resident_blocks(blocks);
  if (err != 0) return err;
  // at most min(K, C) records a frame, L segments each: a block per
  // record and frame where rows are one segment, else a persistent grid
  const long long tickets = static_cast<long long>(B) * min(K, C) * L;
  const dim3 grid = L == 1 ? dim3(min(K, C), B)
                           : dim3(static_cast<unsigned>(
                                 tickets < blocks ? tickets : blocks));
  const Out o{static_cast<int*>(k_out), static_cast<int*>(x_out),
              static_cast<int*>(y_out), static_cast<float*>(sc_out),
              static_cast<uint8_t*>(valid_out)};
  extract_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(S), static_cast<const int*>(work),
      static_cast<int*>(meta), static_cast<unsigned*>(status), o, B, K, M, C,
      T, W, L, vec);
  return static_cast<int>(cudaGetLastError());
}
