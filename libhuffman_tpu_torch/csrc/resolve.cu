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
// position: 101 MB written for the 128-block plan of an 8 MiB text prefix
// (NP = 393216), 32 us at 3.35 TB/s.  The lookups are shared-memory loads
// (one to NS + 1 per position, random banks).
//
// Design: a 1-D grid of (block, slice of words), sized from the card's
// resident CTAs so that it fills the 132 SMs whatever B is; each CTA copies
// its block's 6.5 KB table into shared memory once, with LUT10's dead half
// written as DONE so the unary-root fold costs no compare, and resolves a
// contiguous slice of at least kMinSpan words.  The lookups, not the
// stores, bound it (PERF.md §6: at NS = 0 it is slower than a fill_ of its
// output, and each stage adds to that), so for NS >= 1 each CTA first
// folds LUT10 and stage 1 into one 8192-entry (16 KB) table indexed by the
// window's top 13 bits: one lookup fewer for every position.  NS is a
// template parameter (six instantiations): the cascade is unrolled, and
// each tail stage (taken by few windows: codes of more than 13 bits) is
// skipped by the whole warp unless one of its 256 entries needs it.
// Each warp walks runs of 32 words, loading the next run's words (and the
// word after each) while it resolves the current one, so the loads stay in
// flight.  Lanes map to positions: for 8 words of the run at a time, lane l
// takes positions 8 (l & 3) .. 8 (l & 3) + 7 of word 8 h + (l >> 2), from
// the 64-bit pair (word, next word) shifted once by 8 (l & 3) and then by a
// constant funnel shift per position, so each warp-wide 16-byte store
// writes 512 contiguous bytes.
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W): see PERF.md §6.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTabCells = 13 * 128;
constexpr int kMinSpan = 512;     // words per CTA at least: 32 KB of output
constexpr int kMaxDevices = 64;   // cards whose CTA slots are cached
constexpr uint32_t kDone = 1u << 15;
constexpr uint32_t kDone2 = kDone | (kDone << 16);  // a cell of two DONEs
// u16 entry index of each region of the table.
constexpr int kStage1 = 1024, kTail1 = 2048, kTails = 2560;
constexpr int kFold = 8192;  // entries of the folded LUT10 + stage 1 table

// Tail stage k of a not-DONE entry e for window win: k = 2 is tail 1 (64
// states), k = 3..5 are tails 2-4 (32 states).
__device__ __forceinline__ uint32_t tail(const uint16_t* t, int k, uint32_t e,
                                         uint32_t win) {
  if (k == 2) return t[kTail1 + (((e & 63u) << 3) | ((win >> 16) & 7u))];
  return t[kTails + 256 * (k - 3) +
           (((e & 31u) << 3) | ((win >> (16 - 3 * (k - 2))) & 7u))];
}

template <int NS>
__global__ void __launch_bounds__(kThreads)
resolve_kernel(const uint32_t* __restrict__ words,
               const uint32_t* __restrict__ tables,
               uint4* __restrict__ meta, int W, int S, int span) {
  __shared__ __align__(16) uint32_t tab[kTabCells];
  __shared__ __align__(16) uint16_t fold[NS >= 1 ? kFold : 8];
  const long long b = blockIdx.x / S;
  const int w0 = static_cast<int>(blockIdx.x % S) * span;
  const int w1 = min(W, w0 + span);
  const uint4* tb = reinterpret_cast<const uint4*>(tables + b * kTabCells);
  uint4* t4 = reinterpret_cast<uint4*>(tab);
  for (int i = threadIdx.x; i < kTabCells / 4; i += kThreads) {
    // Cells 256..511 hold LUT10 entries 512..1023: a leading 1 bit.
    t4[i] = i >= 64 && i < 128 ? make_uint4(kDone2, kDone2, kDone2, kDone2)
                               : tb[i];
  }
  __syncthreads();

  const uint16_t* t16 = reinterpret_cast<const uint16_t*>(tab);
  if (NS >= 1) {
    // Entry x of the folded table: the window's top 13 bits are x; a
    // leading 1 is dead, else LUT10's entry of the top 10 bits, or, where
    // that is a state, stage 1's entry of the state and the next 3 bits.
    for (int x = threadIdx.x; x < kFold; x += kThreads) {
      uint32_t e = kDone;
      if (x < kFold / 2) {
        e = t16[x >> 3];
        if (!(e & kDone)) e = t16[kStage1 + (((e & 127u) << 3) | (x & 7u))];
      }
      fold[x] = static_cast<uint16_t>(e);
    }
    __syncthreads();
  }
  const uint32_t* wb = words + b * (W + 128);
  uint4* mb = meta + b * W * 4;
  const int lane = threadIdx.x & 31, q = lane & 3;
  // Each warp takes runs of 32 words: lane l loads word l of the run and
  // the one after it, one run ahead of the run it resolves, and the lanes
  // share them by shuffles.
  int base = w0 + 32 * (threadIdx.x >> 5);
  uint32_t x = 0u, y = 0u;
  if (base + lane < w1) {
    x = wb[base + lane];
    y = wb[base + lane + 1];
  }
  for (; base < w1; base += 32 * kWarps) {
    const int wn = base + 32 * kWarps + lane;
    uint32_t xn = 0u, yn = 0u;
    if (wn < w1) {
      xn = wb[wn];
      yn = wb[wn + 1];
    }
#pragma unroll
    for (int h = 0; h < 4; ++h) {  // 8 words of the run at a time
      const int src = 8 * h + (lane >> 2);
      // The window of position 32 w + s is bits [32 - s, 64 - s) of the
      // pair (word w, word w + 1).
      const uint64_t pair =
          ((static_cast<uint64_t>(__shfl_sync(0xFFFFFFFFu, x, src)) << 32) |
           __shfl_sync(0xFFFFFFFFu, y, src))
          << (8 * q);
      const int w = base + src;
      const uint32_t hi = static_cast<uint32_t>(pair >> 32);
      const uint32_t lo = static_cast<uint32_t>(pair);
      // Lanes past the slice (w >= w1) resolve zero words and store
      // nothing: every lane takes part in the votes below.
      uint32_t e[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint32_t win = __funnelshift_l(lo, hi, j);
        e[j] = NS >= 1 ? fold[win >> 19] : t16[win >> 22];
      }
      // Few windows need a tail stage, so a stage runs only where a lane
      // of the warp still holds an entry that is not DONE.
#pragma unroll
      for (int k = 2; k <= NS; ++k) {
        bool need = false;
#pragma unroll
        for (int j = 0; j < 8; ++j) need |= !(e[j] & kDone);
        if (__any_sync(0xFFFFFFFFu, need)) {
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (!(e[j] & kDone))
              e[j] = tail(t16, k, e[j], __funnelshift_l(lo, hi, j));
        }
      }
      if (w < w1) {
        // Positions 32 w + 8 q .. + 7: uint4 4 w + q of the block's row.
        mb[static_cast<size_t>(w) * 4 + q] =
            make_uint4(e[0] | e[1] << 16, e[2] | e[3] << 16,
                       e[4] | e[5] << 16, e[6] | e[7] << 16);
      }
    }
    x = xn;
    y = yn;
  }
}

template <int NS>
int launch(const uint32_t* words, const uint32_t* tables, uint4* meta, int B,
           int W, cudaStream_t st) {
  // CTAs the current card holds at once (its SMs times the occupancy),
  // found on each card's first launch: the cards of a mesh may differ.
  static std::atomic<int> slots_of[kMaxDevices];
  int dev = 0;
  cudaGetDevice(&dev);
  int slots = dev < kMaxDevices ? slots_of[dev].load(std::memory_order_relaxed)
                                : 0;
  if (!slots) {
    int sms = 0, per = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, resolve_kernel<NS>,
                                                  kThreads, 0);
    slots = sms * per > 0 ? sms * per : 1;
    if (dev < kMaxDevices)
      slots_of[dev].store(slots, std::memory_order_relaxed);
  }
  // Slices per block: the fewest waves of CTAs per slice, i.e. the least
  // time if every slice takes the same, among slices of >= kMinSpan words
  // (more slices than slots never take fewer waves per slice).
  const int smax = max(1, min(slots, W / kMinSpan));
  int S = 1;
  long long best = (static_cast<long long>(B) + slots - 1) / slots;
  for (int s = 2; s <= smax; ++s) {
    const long long waves = (static_cast<long long>(B) * s + slots - 1) / slots;
    if (waves * S < best * s) {
      S = s;
      best = waves;
    }
  }
  const int span = ((W + S - 1) / S + 31) & ~31;  // whole runs
  const long long grid = static_cast<long long>(B) * S;
  if (grid > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  resolve_kernel<NS><<<static_cast<unsigned>(grid), kThreads, 0, st>>>(
      words, tables, meta, W, S, span);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// words (B, W + 128) u32, tables (B, 13, 128) u32 (16-byte aligned) ->
// meta (B, 32 W) u16 (16-byte aligned), every entry written.
extern "C" int huff_resolve(const void* words, const void* tables, void* meta,
                            int B, int W, int NS, void* stream) {
  if (B <= 0 || W <= 0) return static_cast<int>(cudaGetLastError());
  if (NS < 0 || NS > 5) return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(tables) % 16 ||
      reinterpret_cast<uintptr_t>(meta) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const auto* w = static_cast<const uint32_t*>(words);
  const auto* t = static_cast<const uint32_t*>(tables);
  auto* m = static_cast<uint4*>(meta);
  auto st = static_cast<cudaStream_t>(stream);
  switch (NS) {
    case 0: return launch<0>(w, t, m, B, W, st);
    case 1: return launch<1>(w, t, m, B, W, st);
    case 2: return launch<2>(w, t, m, B, W, st);
    case 3: return launch<3>(w, t, m, B, W, st);
    case 4: return launch<4>(w, t, m, B, W, st);
    default: return launch<5>(w, t, m, B, W, st);
  }
}
