// K2: per-byte codeword layout for the encode path.
//
// Replaces libhuffman_tpu/ops/device.py:360 symbol_layout_pallas
// (pallas_call at :376, body _layout_kernel_body at :322-357), which looks
// the 256-entry tables up with 128-lane permutes on the TPU.
//
// Contract: blocks (B, N) u8, codes (B, 256) u32 (right-aligned MSB-first
// codeword values), lens (B, 256) i32, n_valid (B,) i32 ->
// C (B, N) u32 = codes[b, blocks[b, i]] and
// L (B, N) i32 = lens[b, blocks[b, i]] for i < n_valid[b], else 0.  Any N.
//
// Bound on the H100: memory traffic, 9 bytes per input byte (1 read, 4 + 4
// written): 75 MB for a 128-block batch of 64 KiB blocks, 23 us at
// 3.35 TB/s.  Design: each CTA stages its block's two tables (2 KB) in
// shared memory once and then serves kChunk bytes of that block, so the
// table load is amortized over 8 KiB of input; one thread per byte keeps
// loads and stores coalesced.  The (C, L) planes exist only to be read back
// by the packer (K3), which reads L twice (its segment sums, then the pack)
// and C once; fusing the lookup into K3 would have it read the bytes twice
// and the tables in place of those 8 bytes per input byte, and is left to a
// later change.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // == table size: one entry per thread
constexpr int kChunk = 8192;   // input bytes per CTA

__global__ void __launch_bounds__(kThreads)
layout_kernel(const uint8_t* __restrict__ blocks,
              const uint32_t* __restrict__ codes,
              const int32_t* __restrict__ lens,
              const int32_t* __restrict__ n_valid, uint32_t* __restrict__ C,
              int32_t* __restrict__ L, int N, int chunks) {
  __shared__ uint32_t sc[256];
  __shared__ int32_t sl[256];
  const int b = blockIdx.x / chunks;
  const int start = (blockIdx.x % chunks) * kChunk;
  sc[threadIdx.x] = codes[b * 256 + threadIdx.x];
  sl[threadIdx.x] = lens[b * 256 + threadIdx.x];
  __syncthreads();

  const int nv = n_valid[b];
  const int end = min(start + kChunk, N);
  const size_t row = (size_t)b * N;
  for (int i = start + threadIdx.x; i < end; i += kThreads) {
    const int s = blocks[row + i];
    C[row + i] = sc[s];
    L[row + i] = i < nv ? sl[s] : 0;
  }
}

}  // namespace

extern "C" int huff_layout(const void* blocks, const void* codes,
                           const void* lens, const void* n_valid, void* C,
                           void* L, int B, int N, void* stream) {
  const int chunks = (N + kChunk - 1) / kChunk;
  if (B > 0 && chunks > 0) {
    layout_kernel<<<B * chunks, kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(blocks),
        static_cast<const uint32_t*>(codes), static_cast<const int32_t*>(lens),
        static_cast<const int32_t*>(n_valid), static_cast<uint32_t*>(C),
        static_cast<int32_t*>(L), N, chunks);
  }
  return static_cast<int>(cudaGetLastError());
}
