// K5: the codeword that starts at every bit position of every block.
//
// Replaces libhuffman_tpu/ops/decode_v3.py:212 resolve_blocks (pallas_call at
// :245, body _resolve_kernel_body at :129-208), which runs the lookup
// cascade with 128-lane permutes on the TPU and stores adjacent positions
// as pairs in a position-major plane.
//
// Contract: words (B, W + 128) u32, each block's payload as big-endian words,
// zero-padded (the window of the last word reads one word ahead); tables
// (B, 13, 128) u32, the native resolve tables (native/huffman_native.cpp
// build_decode_tables: two u16 entries per cell, entry i in cell i >> 1,
// half i & 1); NS in [0, 5] -> meta (B, 32 W) u16, natural order: meta[b, p]
// is the entry DONE(15) | aux(13:6) | len(5:0) of the codeword at bit p.
// The cascade: LUT10 (512 live entries: a leading 1 bit is the dead entry
// DONE, the unary-root fold), then stage 1 (128 states x 3 bits, cells
// 512..1023), tail 1 (64 states, cells 1024..1279) and tails 2-4 (32 states,
// cells 1280 + 128 k), each taken only while the entry is not DONE.
//
// Bound on the H100: it writes 2 bytes per position and reads 1/8 byte per
// position: 117 MB written for a 128-block plan of NP = 458752 positions, 37 us
// at 3.35 TB/s.  The lookups are shared-memory loads (one to four per
// position, random banks).  Design: the block's 6.5 KB table sits in shared
// memory; one thread per payload word resolves its 32 positions from the
// 64-bit pair (word << 32 | next word), whose window at phase s is bits
// [32 - s, 64 - s), so no shift reaches 32; the 32 u16 results are stored as
// four 16-byte vectors, 64 contiguous bytes per thread.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTabRows = 13;
constexpr int kTabCells = kTabRows * 128;
constexpr uint32_t kDone = 1u << 15;

__device__ __forceinline__ uint32_t entry(const uint32_t* tab, int base,
                                          uint32_t i) {
  return (tab[base + (i >> 1)] >> ((i & 1u) << 4)) & 0xFFFFu;
}

__global__ void __launch_bounds__(kThreads)
resolve_kernel(const uint32_t* __restrict__ words,
               const uint32_t* __restrict__ tables,
               uint4* __restrict__ meta, int W, int NS) {
  __shared__ uint32_t tab[kTabCells];
  const int b = blockIdx.x;
  const uint32_t* tb = tables + (size_t)b * kTabCells;
  for (int i = threadIdx.x; i < kTabCells; i += kThreads) tab[i] = tb[i];
  __syncthreads();

  const int i = blockIdx.y * kThreads + threadIdx.x;
  if (i >= W) return;
  const uint32_t* wb = words + (size_t)b * (W + 128);
  const uint64_t pair =
      (static_cast<uint64_t>(wb[i]) << 32) | static_cast<uint64_t>(wb[i + 1]);
  uint32_t packed[16];
#pragma unroll
  for (int s = 0; s < 32; ++s) {
    const uint32_t win = static_cast<uint32_t>(pair >> (32 - s));
    uint32_t e = (win >> 31) ? kDone : entry(tab, 0, (win >> 22) & 511u);
    for (int k = 1; k <= NS && !(e & kDone); ++k) {
      if (k == 1) {
        e = entry(tab, 512, ((e & 127u) << 3) | ((win >> 19) & 7u));
      } else if (k == 2) {
        e = entry(tab, 1024, ((e & 63u) << 3) | ((win >> 16) & 7u));
      } else {
        const uint32_t bits3 = (win >> (16 - 3 * (k - 2))) & 7u;
        e = entry(tab, 1280 + 128 * (k - 3), ((e & 31u) << 3) | bits3);
      }
    }
    if (s & 1) {
      packed[s >> 1] |= e << 16;
    } else {
      packed[s >> 1] = e;
    }
  }
  // Position 32 i + s lives at u16 index 32 i + s: four uint4 per thread.
  uint4* dst = meta + ((size_t)b * W + i) * 4;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    dst[q] = make_uint4(packed[4 * q], packed[4 * q + 1], packed[4 * q + 2],
                        packed[4 * q + 3]);
  }
}

}  // namespace

// words (B, W + 128) u32, tables (B, 13, 128) u32 -> meta (B, 32 W) u16.
extern "C" int huff_resolve(const void* words, const void* tables, void* meta,
                            int B, int W, int NS, void* stream) {
  if (B <= 0 || W <= 0) return static_cast<int>(cudaGetLastError());
  if (NS < 0 || NS > 5) return static_cast<int>(cudaErrorInvalidValue);
  // Blocks on x: a plan of small blocks can hold more than the 65535 that
  // the y dimension allows.
  const dim3 grid(B, (W + kThreads - 1) / kThreads);
  resolve_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words),
      static_cast<const uint32_t*>(tables), static_cast<uint4*>(meta), W, NS);
  return static_cast<int>(cudaGetLastError());
}
