// K1: per-block byte histograms for the encode path.
//
// Replaces libhuffman_tpu/ops/device.py:145 histogram_pallas (pallas_call at
// :163, body _hist_one at :115-142), which counts bytes as a nibble one-hot
// bf16 contraction on the TPU's matrix unit and subtracts the zero padding
// from slot 0 afterwards.
//
// Contract: blocks (B, N) u8, n_valid (B,) i32 -> out (B, 512) i32 with
// out[b, s] = #{i < n_valid[b] : blocks[b, i] == s} for s < 256 and slots
// 256..511 zero (scratch for build_trees' internal-node rates).  Any N.
// Positions at or past n_valid are not counted, so the result does not
// depend on what the padding holds.
//
// Bound on the H100: it reads each input byte once (8.4 MB for a 128-block
// batch of 64 KiB blocks, 2.5 us at 3.35 TB/s) and does one shared-memory
// atomic per byte, which is the real limit: text repeats a few bytes (space,
// 'e'), so atomics on one counter serialize.  Design: one CTA per block
// (128 CTAs fill the 132 SMs once), 16-byte vector loads, and a private
// 256-counter histogram per warp so that contention stays inside a warp;
// the per-warp histograms are summed once at the end.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
histogram_kernel(const uint8_t* __restrict__ blocks,
                 const int32_t* __restrict__ n_valid,
                 int32_t* __restrict__ out, int N, bool vec) {
  __shared__ uint32_t hist[kWarps][256];
  for (int i = threadIdx.x; i < kWarps * 256; i += kThreads) {
    (&hist[0][0])[i] = 0u;
  }
  __syncthreads();

  const int b = blockIdx.x;
  const int nv = min(max(n_valid[b], 0), N);
  const uint8_t* row = blocks + (size_t)b * N;
  uint32_t* h = hist[threadIdx.x >> 5];

  int tail = 0;
  if (vec) {
    // Row starts are 16-byte aligned (checked by the launcher).
    const int nvec = nv >> 4;
    const uint4* v = reinterpret_cast<const uint4*>(row);
    for (int i = threadIdx.x; i < nvec; i += kThreads) {
      const uint4 q = v[i];
      const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        atomicAdd(&h[w[k] & 255u], 1u);
        atomicAdd(&h[(w[k] >> 8) & 255u], 1u);
        atomicAdd(&h[(w[k] >> 16) & 255u], 1u);
        atomicAdd(&h[w[k] >> 24], 1u);
      }
    }
    tail = nvec << 4;
  }
  for (int i = tail + threadIdx.x; i < nv; i += kThreads) {
    atomicAdd(&h[row[i]], 1u);
  }
  __syncthreads();

  int32_t* o = out + (size_t)b * 512;
  for (int s = threadIdx.x; s < 512; s += kThreads) {
    uint32_t c = 0u;
    if (s < 256) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) c += hist[w][s];
    }
    o[s] = (int32_t)c;
  }
}

}  // namespace

extern "C" int huff_histogram(const void* blocks, const void* n_valid,
                              void* out, int B, int N, void* stream) {
  if (B > 0) {
    const bool vec = (N % 16 == 0) &&
                     (reinterpret_cast<uintptr_t>(blocks) % 16 == 0);
    histogram_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(blocks),
        static_cast<const int32_t*>(n_valid), static_cast<int32_t*>(out), N,
        vec);
  }
  return static_cast<int>(cudaGetLastError());
}
