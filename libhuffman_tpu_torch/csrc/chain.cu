// K6: which positions start a codeword, and each 8-position group's symbols.
//
// Replaces libhuffman_tpu/ops/decode_v3.py:331 chain_emit (pallas_call at
// :376, body _chain_kernel_body at :270-327), which steps every position in
// order on the TPU with a pending-start bitmask per lane, 128 blocks across
// the lanes, and reads a position-major pair plane.
//
// Contract: meta (B, NP) u16 from K5, NP a multiple of 32.  Position 0
// starts; a start p with len(p) = meta & 63 in [1, 31] makes p + len(p) a
// start; len 0 (dead) and the unused 32..63 end the chain (the TPU's schedule
// mask (1 << len) >> 1 is 0 for them), which otherwise runs on through the
// zero padding up to NP.  Outputs, u32, block-major, every word written:
//   start (B, NP/32): bit t of word j = position 32 j + t starts;
//   gw (B, NP/8): group g's aux bytes in start order, kept as (gw << 8) | aux
//     and left-aligned by (32 - 8 c) & 31 at the group's close (c = its
//     count); a dead start's aux byte (its fail offset) counts too;
//   gc4 (B, NP/32): byte k of word j = count of group 4 j + k;
//   gr32 (B, NP/32): starts through stripe j, a running total.
//
// Bound on the H100: the same work needs at least the 2-byte entry of each
// start and the 7 bytes of output per 8 positions (~0.024 ms per 8 MiB of
// mixed input at 3.35 TB/s).  The chain itself is serial: each start's
// entry says where the next one is.
//
// Design: each block is cut into segments of kSeg = 2048 positions (a
// multiple of 32, so every stripe and group lies in one segment and no two
// warps write one word).  A code is at most 31 bits, so the chain enters
// segment k at one of 31 offsets s_k + e, e in [0, 30].  Three launches:
//   map      one warp per segment: the segment's entries go to shared
//            memory in 16-byte loads; lane e walks from s_k + e to the
//            segment's end and records where the chain leaves (the offset
//            into segment k + 1, or END when it ended) and how many starts
//            it passed;
//   compose  one thread per block: from entry 0, each segment's true entry
//            and the starts before it, one map load per segment;
//   write    one warp per segment: the segment again in shared memory, one
//            lane walks it from its true entry and sets the start bits, and
//            the warp derives the group words, counts and running totals
//            from them and writes every output word of the segment,
//            zeros included, with coalesced stores.
// So B * NP / kSeg warps walk in shared memory instead of B threads walking
// device memory, and the chain stays exact: no segment guesses its entry
// (a crafted stream need not resynchronise as Huffman streams tend to).
// It reads the entries twice (2 B per position per pass) instead of once
// per start, which the bound above does not count.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // warps per CTA of map and write, a segment each
constexpr int kThreads = 32 * kWarps;
constexpr int kSeg = 2048;        // cnt fits 16 bits; shared memory < 48 KB
constexpr uint32_t kEnd = 0xFFu;  // map exit / entry: the chain has ended

// A code's length, or 0 where the chain ends at this start (len 0, 32..63).
__device__ __forceinline__ uint32_t step_len(uint16_t e) {
  const uint32_t ln = e & 63u;
  return ln - 1u < 31u ? ln : 0u;
}

// n entries (a multiple of 32) from 16-byte aligned device memory into
// shared memory, 16 bytes a lane.
__device__ __forceinline__ void load_segment(const uint16_t* src,
                                             uint16_t* dst, int n, int lane) {
  const uint4* s4 = reinterpret_cast<const uint4*>(src);
  uint4* d4 = reinterpret_cast<uint4*>(dst);
#pragma unroll 4
  for (int i = lane; i < n / 8; i += 32) d4[i] = __ldg(s4 + i);
}

// Map word of (segment, entry e): exit << 16 | starts counted.
__global__ void __launch_bounds__(kThreads)
chain_map(const uint16_t* __restrict__ meta, uint32_t* __restrict__ map,
          int nseg, int NP, long long nsegs) {
  __shared__ __align__(16) uint16_t seg[kWarps][kSeg];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long id = (long long)blockIdx.x * kWarps + warp;
  if (id >= nsegs) return;
  const long long b = id / nseg;
  const int s = static_cast<int>(id % nseg) * kSeg;
  const int n = min(kSeg, NP - s);
  uint16_t* m = seg[warp];
  load_segment(meta + b * NP + s, m, n, lane);
  __syncwarp();
  int q = lane;
  uint32_t c = 0;
  while (q < n) {
    const uint32_t ln = step_len(m[q]);
    ++c;
    if (ln == 0u) break;
    q += static_cast<int>(ln);
  }
  const uint32_t out = q >= n ? static_cast<uint32_t>(q - n) : kEnd;
  map[id * 32 + lane] = (out << 16) | c;
}

// info[b, k] = (entry of segment k or kEnd, starts before segment k).
__global__ void __launch_bounds__(kThreads)
chain_compose(const uint32_t* __restrict__ map, uint2* __restrict__ info,
              int B, int nseg) {
  const long long b = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (b >= B) return;
  const uint32_t* mb = map + b * nseg * 32;
  uint2* ib = info + b * nseg;
  uint32_t entry = 0, before = 0;
  for (int k = 0; k < nseg; ++k) {
    ib[k] = make_uint2(entry, before);
    if (entry != kEnd) {
      const uint32_t v = mb[k * 32 + entry];
      before += v & 0xFFFFu;
      entry = v >> 16;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
chain_write(const uint16_t* __restrict__ meta, const uint2* __restrict__ info,
            uint32_t* __restrict__ start, uint32_t* __restrict__ gw,
            uint32_t* __restrict__ gc4, uint32_t* __restrict__ gr32,
            int nseg, int NP, long long nsegs) {
  __shared__ __align__(16) uint16_t seg[kWarps][kSeg];
  __shared__ uint32_t words[kWarps][kSeg / 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long id = (long long)blockIdx.x * kWarps + warp;
  if (id >= nsegs) return;
  const long long b = id / nseg;
  const int s = static_cast<int>(id % nseg) * kSeg;
  const int n = min(kSeg, NP - s), nw = n / 32;
  uint16_t* m = seg[warp];
  uint32_t* sw = words[warp];
  const uint2 in = info[id];
  for (int j = lane; j < nw; j += 32) sw[j] = 0u;
  if (in.x != kEnd) {
    load_segment(meta + b * NP + s, m, n, lane);
    __syncwarp();
    if (lane == 0) {  // the walk: start bits, one stripe word at a time
      int q = static_cast<int>(in.x), j = q >> 5;
      uint32_t word = 0;
      while (true) {
        if ((q >> 5) != j) {
          sw[j] = word;
          word = 0;
          j = q >> 5;
        }
        word |= 1u << (q & 31);
        const uint32_t ln = step_len(m[q]);
        if (ln == 0u) break;
        q += static_cast<int>(ln);
        if (q >= n) break;
      }
      sw[j] = word;
    }
  }
  __syncwarp();

  // Stripes: start word, four group counts, running total (a warp scan).
  const long long o32 = b * (NP / 32) + s / 32;
  uint32_t run = in.y;
  for (int j0 = 0; j0 < nw; j0 += 32) {
    const int j = j0 + lane;
    const uint32_t w = j < nw ? sw[j] : 0u;
    uint32_t incl = __popc(w);
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t t = __shfl_up_sync(0xFFFFFFFFu, incl, d);
      if (lane >= d) incl += t;
    }
    if (j < nw) {
      start[o32 + j] = w;
      gc4[o32 + j] = __popc(w & 0xFFu) | __popc(w & 0xFF00u) << 8 |
                     __popc(w & 0xFF0000u) << 16 | __popc(w >> 24) << 24;
      gr32[o32 + j] = run + incl;
    }
    run += __shfl_sync(0xFFFFFFFFu, incl, 31);
  }

  // Groups: the aux bytes of the group's starts, one 16-byte read each.
  const uint4* m4 = reinterpret_cast<const uint4*>(m);
  const long long o8 = b * (NP / 8) + s / 8;
  for (int g = lane; g < n / 8; g += 32) {
    const uint32_t sb = (sw[g >> 2] >> (8 * (g & 3))) & 0xFFu;
    uint32_t word = 0;
    if (sb) {
      const uint4 v = m4[g];
      const uint32_t h[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int t = 0; t < 8; ++t)
        if ((sb >> t) & 1u)
          word = (word << 8) | ((h[t >> 1] >> (16 * (t & 1) + 6)) & 0xFFu);
      word <<= (32u - 8u * __popc(sb)) & 31u;
    }
    gw[o8 + g] = word;
  }
}

int segments(int NP) { return (NP + kSeg - 1) / kSeg; }

}  // namespace

// 32-bit words of scratch huff_chain needs: the map (32 words a segment)
// and the composed entries (2 words a segment).
extern "C" long long huff_chain_scratch_words(int B, int NP) {
  if (B <= 0 || NP <= 0) return 0;
  return (long long)B * segments(NP) * 34;
}

// meta (B, NP) u16, 16-byte aligned -> start, gc4, gr32 (B, NP/32) and
// gw (B, NP/8) u32, every word written; scratch of
// huff_chain_scratch_words(B, NP) words.
extern "C" int huff_chain(const void* meta, void* start, void* gw, void* gc4,
                          void* gr32, void* scratch, int B, int NP,
                          void* stream) {
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  if (NP <= 0 || NP % 32) return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(meta) % 16 ||
      reinterpret_cast<uintptr_t>(scratch) % 8)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const int nseg = segments(NP);
  const long long nsegs = (long long)B * nseg;
  const long long grid = (nsegs + kWarps - 1) / kWarps;
  if (grid > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint16_t* m = static_cast<const uint16_t*>(meta);
  uint32_t* map = static_cast<uint32_t*>(scratch);
  uint2* info = reinterpret_cast<uint2*>(map + nsegs * 32);
  cudaFuncSetAttribute(chain_map,
                       cudaFuncAttributePreferredSharedMemoryCarveout,
                       cudaSharedmemCarveoutMaxShared);
  cudaFuncSetAttribute(chain_write,
                       cudaFuncAttributePreferredSharedMemoryCarveout,
                       cudaSharedmemCarveoutMaxShared);
  chain_map<<<static_cast<unsigned>(grid), kThreads, 0, st>>>(m, map, nseg,
                                                              NP, nsegs);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  chain_compose<<<(B + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      map, info, B, nseg);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  chain_write<<<static_cast<unsigned>(grid), kThreads, 0, st>>>(
      m, info, static_cast<uint32_t*>(start), static_cast<uint32_t*>(gw),
      static_cast<uint32_t*>(gc4), static_cast<uint32_t*>(gr32), nseg, NP,
      nsegs);
  return static_cast<int>(cudaGetLastError());
}
