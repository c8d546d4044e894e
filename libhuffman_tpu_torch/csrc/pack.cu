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
// dropped, never written).  Any N and W.  No clamp, so no other overflow.
//
// Bound on the H100: it reads 8 bytes per input byte (C and L) and writes at
// most 4W bytes: 67 MB read and 12.6 MB written for a 128-block batch of
// 64 KiB blocks (W = 24576), 24 us at 3.35 TB/s.  The per-block scan is
// serial across tiles (N / 1024 steps, three barriers each), so latency
// rather than bandwidth is the first limit.  Design: one CTA per block; each
// 1024-code tile takes an exclusive scan of its lengths (warp shuffles, then
// one warp over the 32 warp totals) plus a running carry, which gives every
// code its bit offset; the bit ranges of different codes are disjoint, so
// each code ORs itself into at most two words with atomicOr and no other
// ordering; the whole word canvas stays in shared memory (96 KB at
// W = 24576, 192 KB at W = 49152, above the default 48 KB and so opted in
// per launch), and one coalesced pass stores it byte-swapped, which is the
// payload's byte order.  A canvas too large for shared memory (blocks above
// 128 KiB) lives in a zeroed global scratch row per block instead.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
static_assert(kWarps == 32, "the second scan level is one warp wide");
// Largest canvas kept in shared memory: 208 KiB of the 227 KiB a block may
// opt into, leaving room for the kernel's static shared memory.
constexpr int kSmemWords = 53248;

__device__ __forceinline__ void put_code(uint32_t* canvas, int W,
                                         long long off, uint32_t c, int ln) {
  const long long w = off >> 5;
  // Left-align the code at its bit offset inside a 64-bit window that
  // starts at word w: the shift is in [1, 63] for ln in [1, 32].
  const int s = 64 - static_cast<int>(off & 31) - ln;
  const unsigned long long v = static_cast<unsigned long long>(c) << s;
  if (w < W) atomicOr(canvas + w, static_cast<uint32_t>(v >> 32));
  const uint32_t lo = static_cast<uint32_t>(v);
  if (lo != 0u && w + 1 < W) atomicOr(canvas + w + 1, lo);
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
pack_kernel(const uint32_t* __restrict__ C, const int32_t* __restrict__ L,
            uint32_t* __restrict__ out, uint8_t* __restrict__ ovf,
            uint32_t* __restrict__ scratch, int N, int W) {
  extern __shared__ uint32_t smem_words[];
  __shared__ int warp_incl[kWarps];
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint32_t* canvas = kShared ? smem_words : scratch + (size_t)b * W;
  if (kShared) {
    for (int i = threadIdx.x; i < W; i += kThreads) canvas[i] = 0u;
  }
  __syncthreads();

  const uint32_t* Cb = C + (size_t)b * N;
  const int32_t* Lb = L + (size_t)b * N;
  long long carry = 0;  // bits before the current tile, same in every thread
  for (int base = 0; base < N; base += kThreads) {
    const int i = base + threadIdx.x;
    int ln = 0;
    uint32_t c = 0u;
    if (i < N) {
      ln = Lb[i];
      c = Cb[i];
    }
    int x = ln;  // inclusive scan within the warp
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, d);
      if (lane >= d) x += y;
    }
    if (lane == 31) warp_incl[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int t = warp_incl[lane];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, t, d);
        if (lane >= d) t += y;
      }
      warp_incl[lane] = t;
    }
    __syncthreads();
    const int before = (warp > 0 ? warp_incl[warp - 1] : 0) + x - ln;
    if (ln > 0) put_code(canvas, W, carry + before, c, ln);
    carry += warp_incl[kWarps - 1];
    __syncthreads();  // warp_incl is rewritten by the next tile
  }
  if (threadIdx.x == 0) ovf[b] = carry > 32LL * W ? 1 : 0;
  if (!kShared) __threadfence_block();
  __syncthreads();

  uint32_t* ob = out + (size_t)b * W;
  for (int i = threadIdx.x; i < W; i += kThreads) {
    // Global-canvas words were built by L2 atomics: read them past L1.
    const uint32_t w = kShared ? canvas[i] : __ldcg(canvas + i);
    ob[i] = __byte_perm(w, 0u, 0x0123);
  }
}

}  // namespace

extern "C" int huff_pack_smem_words() { return kSmemWords; }

// scratch: (B, W) zeroed u32, required when W > huff_pack_smem_words().
extern "C" int huff_pack(const void* C, const void* L, void* out, void* ovf,
                         void* scratch, int B, int N, int W, void* stream) {
  if (B <= 0 || W <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t* c = static_cast<const uint32_t*>(C);
  const int32_t* l = static_cast<const int32_t*>(L);
  uint32_t* o = static_cast<uint32_t*>(out);
  uint8_t* f = static_cast<uint8_t*>(ovf);
  if (W <= kSmemWords) {
    const int bytes = W * 4;
    const cudaError_t e = cudaFuncSetAttribute(
        pack_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    pack_kernel<true><<<B, kThreads, bytes, st>>>(c, l, o, f, nullptr, N, W);
  } else {
    if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    pack_kernel<false><<<B, kThreads, 0, st>>>(
        c, l, o, f, static_cast<uint32_t*>(scratch), N, W);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* huff_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
