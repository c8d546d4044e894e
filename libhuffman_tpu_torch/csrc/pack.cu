// K3: MSB-first bit packing of each block's codewords into its payload.
//
// Replaces libhuffman_tpu/ops/concat_kernel.py:274 concat_words_ovf
// (pallas_call at :303, body _concat_kernel_body at :140-270), which
// concatenates the codewords on the TPU with a bit-reversed halving merge
// tree in VMEM and clamps the tree's intermediate capacity (capw).
//
// Contract: C (B, N) u32 right-aligned codewords (no bits at or above their
// length), L (B, N) i32 lengths in [0, 32] -> out (B, 4W) u8, the first W
// big-endian u32 words of the MSB-first concatenation of the N codewords,
// zero-filled; ovf (B,) u8 = total bits > 32 W (content past word W is
// dropped, never written).  N < 2^26 (bit offsets fit an int), any W.  No
// clamp, so no other overflow.
//
// Bound on the H100: bytes.  It reads 8 bytes per code (C and L) and writes
// 4W bytes: 67 MB read and 12.6 MB written for a 128-block batch of 64 KiB
// blocks (W = 24576), 24 us at 3.35 TB/s.  Reaching it needs the whole card
// busy and some 25 KB of loads in flight per SM.
//
// Design: a thread block cluster of kCluster CTAs per block, each packing
// one segment of N / kCluster codes (B = 128 gives 1024 CTAs of 256
// threads, several resident per SM; a batch of B blocks has 8 B CTAs, so
// batches under 16 blocks leave SMs idle, which costs microseconds).
//   1. Each CTA sums its segment's lengths (four 16-byte loads in flight per
//      thread) and reads its peers' sums through distributed shared memory:
//      that gives its first bit, and every CTA the block's total.
//   2. It packs its segment tile by tile, 2048 codes per tile, 8 per thread
//      (two 16-byte loads each of C and L, the next tile's loads issued
//      before this tile's work, so two tiles are in flight per CTA).  One
//      scan of the threads' 16-bit pair sums gives each thread its bit
//      offsets; a thread gathers its codes in a 64-bit window and ORs each
//      finished word into a ring of kRing words in shared memory with
//      atomicOr (bit ranges of different threads are disjoint).  Words
//      behind the tile's end are final: they are stored byte-swapped
//      (the payload's byte order), coalesced, and their ring slots cleared.
//      So the canvas is bounded whatever W is, and one path serves every W.
//   3. A word is written by the CTA whose segment holds its first bit.  A
//      segment that starts inside a word publishes its bits of that word
//      (its head) in shared memory; after a cluster barrier the word's
//      owner ORs in the heads of the later segments that start in its
//      last word and stores it, so every word is written exactly once.
// The zero fill past the live total is split over the cluster's CTAs, and
// the last CTA writes ovf: every output byte is written once into
// torch.empty, with no zeroing launch and no global scratch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;              // CTAs (segments) per block
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 8;                  // codes per thread per tile
constexpr int kTile = kThreads * kPer;   // 2048 codes
constexpr int kRing = 4096;              // ring words: > kTile + 1
constexpr unsigned kRingMask = kRing - 1;
static_assert(kTile + 2 <= kRing, "a tile's words must fit the ring");
static_assert(kTile / 2 * 32 < 65536, "half-tile sums must fit 16 bits");

__device__ __forceinline__ uint32_t bswap(uint32_t w) {
  return __byte_perm(w, 0u, 0x0123);
}

// Elements i .. i + 3 of a row of C or L (zero past end).  kVec: one
// 16-byte load, with i and end multiples of 4 and the row 16-byte aligned.
template <bool kVec, class V, class T>
__device__ __forceinline__ V load4(const T* __restrict__ p, int i, int end) {
  V v{};
  if (kVec) {
    if (i < end) v = __ldg(reinterpret_cast<const V*>(p + i));
  } else {
    if (i < end) v.x = __ldg(p + i);
    if (i + 1 < end) v.y = __ldg(p + i + 1);
    if (i + 2 < end) v.z = __ldg(p + i + 2);
    if (i + 3 < end) v.w = __ldg(p + i + 3);
  }
  return v;
}

__device__ __forceinline__ int sum4(const int4& l) {
  return l.x + l.y + l.z + l.w;
}

// OR four consecutive codes, starting at block bit ``bit``, into the ring.
__device__ __forceinline__ void put4(uint32_t* ring, int bit, const uint4& c,
                                     const int4& l) {
  const uint32_t cs[4] = {c.x, c.y, c.z, c.w};
  const int ls[4] = {l.x, l.y, l.z, l.w};
  unsigned w = static_cast<unsigned>(bit) >> 5;
  int pos = bit & 31;             // bits of the window's top word before ours
  unsigned long long acc = 0ull;  // window: words w and w + 1, MSB first
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int ln = ls[k];
    if (ln == 0) continue;
    if (pos + ln > 64) {  // then pos > 32: the top word is done
      const uint32_t hi = static_cast<uint32_t>(acc >> 32);
      if (hi) atomicOr(ring + (w & kRingMask), hi);
      acc <<= 32;
      ++w;
      pos -= 32;
    }
    acc |= static_cast<unsigned long long>(cs[k]) << (64 - pos - ln);
    pos += ln;
  }
  const uint32_t hi = static_cast<uint32_t>(acc >> 32);
  const uint32_t lo = static_cast<uint32_t>(acc);
  if (hi) atomicOr(ring + (w & kRingMask), hi);
  if (lo) atomicOr(ring + ((w + 1) & kRingMask), lo);
}

template <bool kVec>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
pack_kernel(const uint32_t* __restrict__ C, const int32_t* __restrict__ L,
            uint32_t* __restrict__ out, uint8_t* __restrict__ ovf, int N,
            int W) {
  __shared__ uint32_t ring[kRing];
  __shared__ unsigned warp_tot[kWarps];
  __shared__ int seg_bits;     // this segment's total length, for the peers
  __shared__ uint32_t head;    // this segment's bits of a word it does not own
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / kCluster;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;

  const int seg = (((N + kCluster - 1) / kCluster) + 3) & ~3;
  const int lo = min(N, rank * seg);
  const int hi = min(N, lo + seg);
  const uint32_t* Cb = C + (size_t)b * N;
  const int32_t* Lb = L + (size_t)b * N;
  uint32_t* ob = out + (size_t)b * W;

  for (int i = t; i < kRing; i += kThreads) ring[i] = 0u;
  if (t == 0) head = 0u;

  // ---- 1. this segment's total length ------------------------------------
  int s = 0;
  for (int i = lo + 4 * t; i < hi; i += 4 * 4 * kThreads) {
    int4 l[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      l[u] = load4<kVec, int4>(Lb, i + u * 4 * kThreads, hi);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) s += sum4(l[u]);
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) s += __shfl_xor_sync(0xffffffffu, s, d);
  if (lane == 0) warp_tot[warp] = s;
  __syncthreads();
  if (t == 0) {
    int tot = 0;
    for (int w = 0; w < kWarps; ++w) tot += warp_tot[w];
    seg_bits = tot;
  }
  cluster.sync();  // every segment's total is published

  // This segment's bit range [my0, my1) and the block's total, from a
  // scan over lanes 0 .. kCluster - 1, lane r holding segment r's total.
  const int nb = lane < kCluster ? *cluster.map_shared_rank(&seg_bits, lane)
                                 : 0;
  int incl = nb;
#pragma unroll
  for (int d = 1; d < kCluster; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += y;
  }
  const int total = __shfl_sync(0xffffffffu, incl, kCluster - 1);
  const int my1 = __shfl_sync(0xffffffffu, incl, rank);
  const int my0 = my1 - __shfl_sync(0xffffffffu, nb, rank);
  const long long cap = 32LL * W;

  // Zero fill: words [ceil(total / 32), W), split over the cluster.
  {
    const int zs = static_cast<int>(min(static_cast<long long>(W),
                                        (total + 31LL) >> 5));
    const int q = (W - zs + kCluster - 1) / kCluster;
    const int z0 = zs + rank * q;
    const int z1 = min(W, z0 + q);
    for (int i = z0 + t; i < z1; i += kThreads) ob[i] = 0u;
  }
  if (rank == kCluster - 1 && t == 0) ovf[b] = total > cap ? 1 : 0;

  // ---- 2. pack the segment ------------------------------------------------
  // The head word hw holds earlier segments' bits when my0 is not aligned.
  const unsigned hw = static_cast<unsigned>(my0) >> 5;
  const bool foreign_head = (my0 & 31) != 0 && my1 > my0;
  unsigned next = hw;  // first ring word not yet stored
  int base = my0;      // block bit where the current tile starts
  bool done = my0 >= my1 || my0 >= cap;
  if (!done) {
    uint4 c[2];
    int4 l[2];
    // Thread t's codes of a tile are 4t..4t+3 and kTile/2 + 4t..+3, so each
    // 16-byte load instruction of a warp reads 512 contiguous bytes.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      c[h] = load4<kVec, uint4>(Cb, lo + h * kTile / 2 + 4 * t, hi);
      l[h] = load4<kVec, int4>(Lb, lo + h * kTile / 2 + 4 * t, hi);
    }
    for (int i0 = lo; i0 < hi; i0 += kTile) {
      uint4 nc[2];
      int4 nl[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = i0 + kTile + h * kTile / 2 + 4 * t;
        nc[h] = load4<kVec, uint4>(Cb, n, hi);
        nl[h] = load4<kVec, int4>(Lb, n, hi);
      }

      // Exclusive scan of (half-0 sum) | (half-1 sum) << 16 over threads,
      // unsigned: a half's total reaches 2^15.
      const unsigned v = static_cast<unsigned>(sum4(l[0])) |
                         (static_cast<unsigned>(sum4(l[1])) << 16);
      unsigned x = v;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const unsigned y = __shfl_up_sync(0xffffffffu, x, d);
        if (lane >= d) x += y;
      }
      if (lane == 31) warp_tot[warp] = x;
      __syncthreads();
      unsigned before = 0u, tot = 0u;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const unsigned y = warp_tot[w];
        if (w < warp) before += y;
        tot += y;
      }
      const unsigned ex = before + x - v;
      const int half0 = static_cast<int>(tot & 0xFFFFu);
      put4(ring, base + static_cast<int>(ex & 0xFFFFu), c[0], l[0]);
      put4(ring, base + half0 + static_cast<int>(ex >> 16), c[1], l[1]);
      __syncthreads();  // the tile's words are in the ring

      base += half0 + static_cast<int>(tot >> 16);
      const unsigned end = static_cast<unsigned>(base) >> 5;  // words before
      for (unsigned w = next + t; w < end; w += kThreads) {
        const uint32_t val = ring[w & kRingMask];
        ring[w & kRingMask] = 0u;
        if (w == hw && foreign_head) {
          head = val;
        } else if (w < static_cast<unsigned>(W)) {
          ob[w] = bswap(val);
        }
      }
      next = end;
      if (base >= cap) break;  // the rest lies past the budget
      c[0] = nc[0];
      c[1] = nc[1];
      l[0] = nl[0];
      l[1] = nl[1];
    }
    __syncthreads();  // the flush is done before the last word is read
  }

  // The segment's last, partial word: its own unless it is the head word.
  uint32_t tail = 0u;
  const bool has_tail = !done && base < cap && (my1 & 31) != 0;
  const unsigned lw = static_cast<unsigned>(my1) >> 5;
  if (has_tail && t == 0) {
    const uint32_t val = ring[lw & kRingMask];
    if (lw == hw && foreign_head) head = val;
    else tail = val;
  }
  cluster.sync();  // every head is published

  // ---- 3. the owner of the last word merges the later segments' heads ----
  if (has_tail && t == 0 && !(lw == hw && foreign_head) &&
      lw < static_cast<unsigned>(W)) {
    int st = my1;  // where segment r starts
    for (int r = rank + 1; r < kCluster; ++r) {
      const int nr = *cluster.map_shared_rank(&seg_bits, r);
      if (nr == 0) continue;  // an empty segment
      if ((static_cast<unsigned>(st) >> 5) != lw) break;
      tail |= *cluster.map_shared_rank(&head, r);
      st += nr;
    }
    ob[lw] = bswap(tail);
  }
  cluster.sync();  // no CTA leaves while a peer may read its shared memory
}

}  // namespace

extern "C" int huff_pack(const void* C, const void* L, void* out, void* ovf,
                         int B, int N, int W, void* stream) {
  if (N < 0 || N >= (1 << 26) || W <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t* c = static_cast<const uint32_t*>(C);
  const int32_t* l = static_cast<const int32_t*>(L);
  uint32_t* o = static_cast<uint32_t*>(out);
  uint8_t* f = static_cast<uint8_t*>(ovf);
  const bool vec = N % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(C) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(L) % 16 == 0;
  if (vec) {
    pack_kernel<true><<<B * kCluster, kThreads, 0, st>>>(c, l, o, f, N, W);
  } else {
    pack_kernel<false><<<B * kCluster, kThreads, 0, st>>>(c, l, o, f, N, W);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* huff_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
