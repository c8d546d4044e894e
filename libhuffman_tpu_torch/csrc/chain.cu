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
// zero padding up to NP.  Outputs, u32, block-major:
//   start (B, NP/32): bit t of word j = position 32 j + t starts;
//   gw (B, NP/8): group g's aux bytes in start order, kept as (gw << 8) | aux
//     and left-aligned by (32 - 8 c) & 31 at the group's close (c = its
//     count); a dead start's aux byte (its fail offset) counts too;
//   gc4 (B, NP/32): byte k of word j = count of group 4 j + k;
//   gr32 (B, NP/32): starts through stripe j, a running total.
// start, gw and gc4 must arrive zeroed: the walk writes only the words of
// the groups and stripes that hold a start.  gr32 is written whole.
//
// Bound on the H100: it reads at least the 2-byte entry of each start and
// writes 6 bytes per 32 positions plus one word per live group; for a 128-block
// plan of NP = 458752 that is ~17 MB read and ~30 MB written, ~14 us at
// 3.35 TB/s.  The real limit is latency: each start's entry is a load that
// depends on the previous one.  Design: one thread per block jumps from
// start to start (p += len(p)), so the walk costs one dependent load per
// symbol, not one step per position; the entries of one block are read in
// increasing order, so most loads hit a cache line the previous load
// brought in.  Only B threads run (16 warps for a 512-block plan): a warp
// or pointer doubling per block is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 32;

__global__ void __launch_bounds__(kThreads)
chain_kernel(const uint16_t* __restrict__ meta, uint32_t* __restrict__ start,
             uint32_t* __restrict__ gw, uint32_t* __restrict__ gc4,
             uint32_t* __restrict__ gr32, int B, int NP) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= B) return;
  const int NW = NP / 32;
  const uint16_t* m = meta + (size_t)b * NP;
  uint32_t* st = start + (size_t)b * NW;
  uint32_t* g8 = gw + (size_t)b * (NP / 8);
  uint32_t* c4 = gc4 + (size_t)b * NW;
  uint32_t* gr = gr32 + (size_t)b * NW;

  uint32_t total = 0;  // starts so far
  int j = 0;           // open stripe
  uint32_t word = 0, cells = 0;
  int g = 0;           // open group
  uint32_t gword = 0, gcnt = 0;
  int p = 0;
  while (true) {
    const int pg = p >> 3;
    if (pg != g) {  // close group g
      if (gcnt) {
        g8[g] = gword << ((32u - 8u * gcnt) & 31u);
        cells |= gcnt << (8 * (g & 3));
      }
      gword = 0;
      gcnt = 0;
      const int pj = p >> 5;
      if (pj != j) {  // close stripe j and the empty stripes up to pj
        st[j] = word;
        c4[j] = cells;
        for (int k = j; k < pj; ++k) gr[k] = total;
        word = 0;
        cells = 0;
        j = pj;
      }
      g = pg;
    }
    const uint32_t e = m[p];
    word |= 1u << (p & 31);
    gword = (gword << 8) | ((e >> 6) & 255u);
    ++gcnt;
    ++total;
    const uint32_t ln = e & 63u;
    if (ln == 0u || ln >= 32u) break;
    p += static_cast<int>(ln);
    if (p >= NP) break;
  }
  g8[g] = gword << ((32u - 8u * gcnt) & 31u);
  cells |= gcnt << (8 * (g & 3));
  st[j] = word;
  c4[j] = cells;
  for (int k = j; k < NW; ++k) gr[k] = total;
}

}  // namespace

// meta (B, NP) u16 -> start, gc4, gr32 (B, NP/32) and gw (B, NP/8) u32;
// start, gw and gc4 zeroed by the caller.
extern "C" int huff_chain(const void* meta, void* start, void* gw, void* gc4,
                          void* gr32, int B, int NP, void* stream) {
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  if (NP <= 0 || NP % 32) return static_cast<int>(cudaErrorInvalidValue);
  chain_kernel<<<(B + kThreads - 1) / kThreads, kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(meta), static_cast<uint32_t*>(start),
      static_cast<uint32_t*>(gw), static_cast<uint32_t*>(gc4),
      static_cast<uint32_t*>(gr32), B, NP);
  return static_cast<int>(cudaGetLastError());
}
