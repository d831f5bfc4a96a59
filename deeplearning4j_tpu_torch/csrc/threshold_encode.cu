// Fixed-threshold encode (kernel K6) for Hopper: every bucket of a step in one
// launch and one pass over the gradient.
//
// Replaces deeplearning4j_tpu/ops/compression.py::_encode_kernel (launched by
// _pallas_pack, one pallas_call per bucket).  Same function as the reference's
// plain twin _streaming_pack, applied to each bucket b of a table:
//   in   g_b = g[g_off_b, g_off_b + n_b) f32, threshold t > 0, capacity k_b;
//   out  out[msg_off_b, msg_off_b + k_b) int32: sign(g_i) * (i + 1) for every i
//        with |g_i| >= t, in ascending i (i counted within the bucket), then
//        zeros; selections past k_b are dropped, as the plain version drops
//        them (the caller encodes such a bucket again with the top-k pack);
//        counts[b]: the bucket's number of selections (it may exceed k_b).
// The output is bitwise the plain version's: the slot of a selected element is
// the number of selections before it in its bucket, whatever order the blocks
// run in.  The only atomic is an integer ticket; no floating-point atomics.
//
// Design.  On the TPU one grid step holds a whole bucket in VMEM and runs a
// cumsum over it, so each bucket was its own pallas_call (capped at 8 MB).
// Here the buckets are cut into tiles of 4096 elements (256 threads x 4
// 128-bit loads), and runs of up to 16 tiles of one bucket into segments (the
// caller picks the run length, so that a small launch still has a block for
// each tile).  One launch runs every segment of every bucket in a single pass
// with decoupled look-back:
//   1. a block takes its segment from an integer ticket, so segments start in
//      ticket order and a block only ever waits on segments that are already
//      running, and reads the segment's row of a table (first element, bucket,
//      length): one dependent load before the data's;
//   2. it streams the segment's tiles through registers, the next tile's loads
//      in flight while it counts the last (16 values a thread: round r of
//      thread j holds elements r*1024 + 4j + [0, 4), one float4 where the
//      tile is whole and 16-byte aligned, else one value at a time: a bucket's
//      last tile, and every tile of a bucket whose start is not 16-byte
//      aligned); of each tile it keeps only a selection mask and a sign mask,
//      2 bits an element, in shared memory, and each warp's four per-round
//      counts, packed in 16-bit fields of one 64-bit word;
//   3. it publishes the segment's count in its 64-bit status word (flag << 32
//      | count); the bucket's first segment publishes it as an inclusive
//      prefix;
//   4. warp 0 looks back over the predecessors' words, 32 at a time, and sums
//      their counts up to the nearest inclusive prefix or the bucket's first
//      segment (a 4 MiB bucket has 16 segments: one round); it publishes the
//      segment's inclusive prefix;
//   5. it scatters the selections from the masks, so g is read once: a
//      thread's slot is the segment's prefix, the tiles and rounds before it,
//      and the warp scan of the per-round counts (shuffles);
//   6. the bucket's last segment writes counts[b] and zeroes slots [count, k).
//      A memset of the messages before the launch would write every slot that
//      holds a selection twice (4 bytes per selection more, and a second launch).
// The status words carry their own payload and order nothing else (messages
// of different segments are disjoint, and the zeros lie past every
// selection), so they are stored and loaded relaxed at device scope, each
// 64-bit word whole; release / acquire ordering costs 4% of the step's time
// (scripts/k5b_k6_variants.py, H100) and buys nothing here.  Streaming 16
// tiles a block, not one, takes the step from 0.53 to 0.32 ms (the same
// script): a block's ticket, table row, look-back and exit are paid once a
// segment, and its next tile's loads stay in flight.
// Bound on H100: bytes.  Sum of 4n_b read and 4k_b written at 3.35 TB/s: the
// compressed phase's 156 buckets (163,131,264 elements, sum k = 10,195,704)
// move 693 MB, 0.207 ms.  The scratch (one status word per segment, then the
// ticket) is zeroed by the caller before the launch: its one memset.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRounds = 4;                       // float4 loads a thread a tile
constexpr int kRoundElems = 4 * kThreads;        // 1024
constexpr int kTile = kRounds * kRoundElems;     // 4096: ENC_TILE in ops/compression.py
constexpr int kSegTiles = 16;                    // the most tiles a segment: ENC_SEG_TILES
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kAggregate = 1ull << 32;  // the word holds the segment's count
constexpr unsigned long long kPrefix = 2ull << 32;     // ... the bucket's count through it

// one row of the bucket table (ops/compression.py::_encode_table writes it)
struct Bucket {
  long long g_off;    // the bucket's first element in g
  long long msg_off;  // its message's first slot in out
  int n, k;           // elements (>= 0), capacity (>= 0)
  int first_seg;      // its first segment in the launch
  int segs;           // its segments
};

// one row of the segment table: all a block needs before its loads
struct Segment {
  long long src;  // the segment's first element in g
  int bucket;     // its row of the bucket table
  int valid;      // its elements: seg_tiles * kTile, or fewer at a bucket's end
};

__device__ __forceinline__ void store_relaxed(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.b64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long load_relaxed(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.b64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

// tile q of a segment into registers: 16 values a thread, zeros past `valid`
__device__ __forceinline__ void load_tile(float* v, const float* src, int q, int valid,
                                          bool aligned) {
  const float* p = src + q * kTile;
  const int left = valid - q * kTile;
  if (aligned && left >= kTile) {
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      const float4 x = __ldcs(reinterpret_cast<const float4*>(p + r * kRoundElems) + threadIdx.x);
      v[4 * r] = x.x;
      v[4 * r + 1] = x.y;
      v[4 * r + 2] = x.z;
      v[4 * r + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int r = 0; r < kRounds; ++r)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = r * kRoundElems + 4 * threadIdx.x + e;
        v[4 * r + e] = i < left ? p[i] : 0.0f;  // t > 0: a pad never selects
      }
  }
}

// the four rounds' selection counts of a thread, 16 bits each
__device__ __forceinline__ unsigned long long round_counts(unsigned sel) {
  unsigned long long c = 0;
#pragma unroll
  for (int r = 0; r < kRounds; ++r)
    c |= (unsigned long long)__popc((sel >> (4 * r)) & 0xFu) << (16 * r);
  return c;
}

// inclusive scan of x over the warp
__device__ __forceinline__ unsigned long long warp_scan(unsigned long long x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned long long y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  return x;
}

// tile q's masks into shared memory (bit 4r + e: a selection; bit 16 + 4r + e:
// a negative value), and its warp's packed per-round counts
__device__ __forceinline__ void count_tile(const float* v, float t, int q, unsigned* s_mask,
                                           unsigned long long* s_wcnt) {
  unsigned sel = 0, neg = 0;
#pragma unroll
  for (int i = 0; i < 4 * kRounds; ++i) {
    sel |= (fabsf(v[i]) >= t ? 1u : 0u) << i;
    neg |= (v[i] < 0.0f ? 1u : 0u) << i;
  }
  s_mask[q * kThreads + threadIdx.x] = sel | neg << 16;
  const unsigned long long incl = warp_scan(round_counts(sel));
  if ((threadIdx.x & 31) == 31) s_wcnt[q * kWarps + (threadIdx.x >> 5)] = incl;
}

// p[0, len) = 0 by the whole block: int4 stores between a scalar head and tail
__device__ void zero_block(int* p, int len) {
  int head = (int)(((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15) >> 2);
  if (head > len) head = len;
  if ((int)threadIdx.x < head) p[threadIdx.x] = 0;
  int4* q = reinterpret_cast<int4*>(p + head);
  const int quads = (len - head) >> 2;
  for (int i = threadIdx.x; i < quads; i += kThreads) q[i] = make_int4(0, 0, 0, 0);
  const int tail = head + 4 * quads + threadIdx.x;
  if (tail < len) p[tail] = 0;
}

__global__ void __launch_bounds__(kThreads)
threshold_encode_kernel(const float* __restrict__ g, float t, const Bucket* __restrict__ table,
                        const Segment* __restrict__ segments, int seg_tiles,
                        int* __restrict__ out, int* __restrict__ counts,
                        unsigned long long* __restrict__ status, unsigned* __restrict__ ticket) {
  __shared__ unsigned s_mask[kSegTiles * kThreads];
  __shared__ unsigned long long s_wcnt[kSegTiles * kWarps];
  __shared__ int s_base[kSegTiles];  // selections in the segment before tile q
  __shared__ int s_seg, s_total, s_excl;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // 1. the segment, by ticket
  if (tid == 0) s_seg = (int)atomicAdd(ticket, 1u);
  __syncthreads();
  const int seg = s_seg;
  const Segment sg = segments[seg];
  const float* src = g + sg.src;
  const bool aligned = (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  const int nt = sg.valid > 0 ? (sg.valid + kTile - 1) / kTile : 1;

  // 2. stream the tiles: one tile's loads in flight while the other's count
  float v[4 * kRounds], w[4 * kRounds];
  load_tile(v, src, 0, sg.valid, aligned);
  for (int q = 0; q < nt; q += 2) {
    if (q + 1 < nt) load_tile(w, src, q + 1, sg.valid, aligned);
    count_tile(v, t, q, s_mask, s_wcnt);
    if (q + 1 >= nt) break;
    if (q + 2 < nt) load_tile(v, src, q + 2, sg.valid, aligned);
    count_tile(w, t, q + 1, s_mask, s_wcnt);
  }
  const Bucket bk = table[sg.bucket];
  __syncthreads();
  if (warp == 0) {  // the tiles' totals, and their exclusive sums
    int c = 0;
    if (lane < nt) {
      unsigned long long all = 0;
#pragma unroll
      for (int x = 0; x < kWarps; ++x) all += s_wcnt[lane * kWarps + x];
#pragma unroll
      for (int r = 0; r < kRounds; ++r) c += (int)((all >> (16 * r)) & 0xFFFFu);
    }
    int incl = c;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += y;
    }
    if (lane < nt) s_base[lane] = incl - c;
    if (lane == 31) s_total = incl;
  }
  __syncthreads();
  const int total = s_total;

  // 3. publish the count; 4. look back, then publish the inclusive prefix
  if (warp == 0) {
    int excl = 0;
    if (seg == bk.first_seg) {
      if (lane == 0) store_relaxed(status + seg, kPrefix | (unsigned)total);
    } else {
      if (lane == 0) store_relaxed(status + seg, kAggregate | (unsigned)total);
      for (int pred = seg - 1;; pred -= 32) {
        const int idx = pred - lane;
        unsigned long long s = kPrefix;  // before the bucket: a prefix of 0
        if (idx >= bk.first_seg) {
          do {
            s = load_relaxed(status + idx);
          } while ((s >> 32) == 0);
        }
        const unsigned prefixes = __ballot_sync(kFull, (s >> 32) == 2);
        // lanes past the nearest prefix (the lowest lane that holds one) add nothing
        const int c = prefixes && lane >= __ffs(prefixes) ? 0 : (int)(unsigned)s;
        excl += __reduce_add_sync(kFull, c);
        if (prefixes) break;
      }
      if (lane == 0) store_relaxed(status + seg, kPrefix | (unsigned)(excl + total));
    }
    if (lane == 0) s_excl = excl;
  }
  __syncthreads();

  // 5. scatter from the masks
  const int excl = s_excl;
  const int start = (seg - bk.first_seg) * seg_tiles * kTile;  // the segment in its bucket
  int* msg = out + bk.msg_off;
  for (int q = 0; q < nt; ++q) {
    const unsigned m = s_mask[q * kThreads + tid];
    const unsigned sel = m & 0xFFFFu, neg = m >> 16;
    const unsigned long long mine = round_counts(sel);
    unsigned long long before = warp_scan(mine) - mine, all = 0;
#pragma unroll
    for (int x = 0; x < kWarps; ++x) {
      const unsigned long long c = s_wcnt[q * kWarps + x];
      if (x < warp) before += c;
      all += c;
    }
    if (sel == 0) continue;
    int base = excl + s_base[q];
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      int slot = base + (int)((before >> (16 * r)) & 0xFFFFu);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if ((sel >> (4 * r + e)) & 1u) {
          const int i = start + q * kTile + r * kRoundElems + 4 * tid + e + 1;
          if (slot < bk.k) msg[slot] = (neg >> (4 * r + e)) & 1u ? -i : i;
          ++slot;
        }
      }
      base += (int)((all >> (16 * r)) & 0xFFFFu);
    }
  }

  // 6. the bucket's last segment: its count, then zeros after the selections
  if (seg == bk.first_seg + bk.segs - 1) {
    const int count = excl + total;
    if (tid == 0) counts[sg.bucket] = count;
    if (count < bk.k) zero_block(msg + count, bk.k - count);
  }
}

}  // namespace

// g f32 (every bucket's elements), threshold t > 0; table: Bucket rows and
// seg_table: `segments` Segment rows of seg_tiles tiles at most, on the device;
// out int32 (every bucket's message); counts int32[one per bucket]; scratch
// uint64[segments + 1] zeroed (the status words, then the ticket).  The caller
// checks the tables against g and out.  Returns 0, a CUDA error code, or -1 for
// arguments it does not take.
extern "C" int dl4j_threshold_encode(const void* g, float t, const void* table,
                                     const void* seg_table, int segments, int seg_tiles,
                                     void* out, void* counts, void* scratch, void* stream) {
  if (segments < 1 || seg_tiles < 1 || seg_tiles > kSegTiles || !(t > 0.0f)) return -1;
  unsigned long long* status = static_cast<unsigned long long*>(scratch);
  threshold_encode_kernel<<<segments, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), t, static_cast<const Bucket*>(table),
      static_cast<const Segment*>(seg_table), seg_tiles, static_cast<int*>(out),
      static_cast<int*>(counts), status, reinterpret_cast<unsigned*>(status + segments));
  return (int)cudaGetLastError();
}
