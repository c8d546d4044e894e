// K1: per-block byte histograms for the encode path.
//
// Replaces libhuffman_tpu/ops/device.py:145 histogram_pallas (pallas_call at
// :163, body _hist_one at :115-142), which counts bytes as a nibble one-hot
// bf16 contraction on the TPU's matrix unit and subtracts the zero padding
// from slot 0 afterwards.
//
// Contract: blocks (B, N) u8, n_valid (B,) i32 -> out (B, 512) i32 with
// out[b, s] = #{i < n_valid[b] : blocks[b, i] == s} for s < 256 and slots
// 256..511 zero (scratch for build_trees' internal-node rates).  Any N and
// any row alignment.  Positions at or past n_valid are not counted, so the
// result does not depend on what the padding holds.
//
// Bound on the H100: bytes, 8.4 MB read for a 128-block batch of 64 KiB
// blocks, 2.5 us at 3.35 TB/s.  At that size the launch ramp and the first
// loads' latency dominate: one torch.sum over the same bytes takes longer
// than K1 (chip_smoke.py's ``limits [encode]`` line), so a launch of K1
// cannot come near its bytes bound.  Counting takes one shared-memory
// atomic per byte, and on text a few bytes (space, 'e') are hot: lanes
// that add to one counter in one instruction serialize.
// Design: a thread block cluster of kCluster CTAs per block, each counting
// one segment of N / kCluster bytes (B = 128 gives 256 CTAs of 256 threads).
// A thread keeps its next 16-byte load in flight while it counts the
// current one: issuing all of a thread's loads before its atomics left the
// CTA idle through the loads' latency and was slower on the card.  The
// counters are one column per lane, hist[symbol][lane], shared by the
// CTA's warps: the 32 lanes of an atomic instruction always hit 32 banks
// and never one counter, however hot a byte is.  Each CTA sums its columns
// and stores its 256 counts into a row of CTA 0's shared memory through
// distributed shared memory; after one cluster barrier CTA 0 writes the
// output row once into torch.empty, with no memset and no global atomics.
// The cluster's first barrier phase is armed at the start and waited on
// only before the remote stores, so it costs no waiting.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 2;   // CTAs (segments) per block
constexpr int kThreads = 256;
constexpr int kSlots = 512;   // output row

__device__ __forceinline__ void arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wait_acquire() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void count4(uint32_t* h, uint32_t w) {
  atomicAdd(h + (w & 255u) * 32, 1u);
  atomicAdd(h + ((w >> 8) & 255u) * 32, 1u);
  atomicAdd(h + ((w >> 16) & 255u) * 32, 1u);
  atomicAdd(h + (w >> 24) * 32, 1u);
}

template <bool kVec>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
histogram_kernel(const uint8_t* __restrict__ blocks,
                 const int32_t* __restrict__ n_valid,
                 int32_t* __restrict__ out, int N) {
  __shared__ __align__(16) uint32_t hist[256 * 32];  // [symbol][lane]
  __shared__ uint32_t part[kCluster][256];  // CTA 0: every CTA's counts
  arrive_relaxed();  // phase 1: this CTA has started
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / kCluster;
  const int t = threadIdx.x;

  uint4* h4 = reinterpret_cast<uint4*>(hist);
  for (int i = t; i < 256 * 32 / 4; i += kThreads) {
    h4[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();

  const int seg = (((N + kCluster - 1) / kCluster) + 15) & ~15;
  const int lo = min(N, rank * seg);
  const int hi = min(N, lo + seg);
  const int nv = min(max(n_valid[b], 0), N);
  const int end = max(lo, min(hi, nv));  // count [lo, end)
  const uint8_t* row = blocks + (size_t)b * N;
  uint32_t* h = hist + (t & 31);

  int tail = lo;
  if (kVec) {
    // Rows and segments start 16-byte aligned (checked by the launcher).
    const uint4* v = reinterpret_cast<const uint4*>(row + lo);
    const int nvec = (end - lo) >> 4;
    uint4 cur = t < nvec ? __ldg(v + t) : make_uint4(0u, 0u, 0u, 0u);
    for (int j = t; j < nvec; j += kThreads) {
      const int jn = j + kThreads;
      const uint4 nxt = jn < nvec ? __ldg(v + jn) : make_uint4(0u, 0u, 0u, 0u);
      count4(h, cur.x);
      count4(h, cur.y);
      count4(h, cur.z);
      count4(h, cur.w);
      cur = nxt;
    }
    tail = lo + (nvec << 4);
  }
  // The bytes the vector loop leaves (fewer than 16), or all of them for an
  // unaligned row: 16 loads per thread, then their atomics.
  for (int i0 = tail; i0 < end; i0 += 16 * kThreads) {
    uint32_t s[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int i = i0 + k * kThreads + t;
      s[k] = i < end ? __ldg(row + i) : 256u;
    }
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      if (s[k] < 256u) atomicAdd(h + s[k] * 32, 1u);
    }
  }
  __syncthreads();

  // Sum the lane columns of each symbol (rotated, so that the lanes of a
  // warp read 32 banks) into this CTA's row of CTA 0's part.
  wait_acquire();  // phase 1: every CTA has started, CTA 0's part exists
  uint32_t* dst = cluster.map_shared_rank(&part[rank][0], 0);
  for (int s = t; s < 256; s += kThreads) {
    uint32_t c = 0u;
#pragma unroll 8
    for (int k = 0; k < 32; ++k) c += hist[s * 32 + ((k + s) & 31)];
    dst[s] = c;
  }
  arrive_release();  // phase 2: the counts are stored
  if (rank != 0) return;  // nobody reads this CTA's shared memory
  wait_acquire();
  for (int s = t; s < kSlots; s += kThreads) {
    uint32_t c = 0u;
    if (s < 256) {
#pragma unroll
      for (int r = 0; r < kCluster; ++r) c += part[r][s];
    }
    out[(size_t)b * kSlots + s] = static_cast<int32_t>(c);
  }
}

}  // namespace

extern "C" int huff_histogram(const void* blocks, const void* n_valid,
                              void* out, int B, int N, void* stream) {
  if (B > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const uint8_t* x = static_cast<const uint8_t*>(blocks);
    const int32_t* nv = static_cast<const int32_t*>(n_valid);
    int32_t* o = static_cast<int32_t*>(out);
    const bool vec = (N % 16 == 0) &&
                     (reinterpret_cast<uintptr_t>(blocks) % 16 == 0);
    if (vec) {
      histogram_kernel<true><<<B * kCluster, kThreads, 0, st>>>(x, nv, o, N);
    } else {
      histogram_kernel<false><<<B * kCluster, kThreads, 0, st>>>(x, nv, o, N);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
