// K4: the decoded bytes of each block, from the chain's group words.
//
// Replaces libhuffman_tpu/ops/concat_kernel.py:340 concat_groups_ovf
// (pallas_call at :362, body _concat_kernel_body at :140-270 with packed
// counts), fed by decode_v3.py:414-475 _emit_from_chain: a bit-reversed
// halving merge tree over the group strings in VMEM, with a capacity clamp
// (ECW) that flags blocks it cannot hold.
//
// Contract: gw (B, NG) u32 left-aligned group words, gc4 (B, NG/4) u32
// packed counts (byte k of word j = count of group 4 j + k, live-masked by
// the caller), OUTW -> out (B, 4 OUTW) u8, the first 4 OUTW bytes of the
// groups' strings joined in group order, zero-filled.  Group g's string is
// its count c of bytes, byte i being byte i of gw from the top for i < 4 and
// zero past it.  Every output byte is written once.  No clamp, so no
// overflow flag: bytes past 4 OUTW are dropped (they lie past n_sym).
//
// Bound on the H100: it reads 4 + 1 bytes per group and writes each output
// byte once: 29.4 + 7.3 MB read and 8.4 MB written for a 128-block plan of
// NG = 57344 groups and OUTW = 16384, 13 us at 3.35 TB/s.  Design: the
// strings are whole bytes, so no bit shifting is needed: one CTA per block
// takes an exclusive scan of the counts over 1024-group tiles (warp
// shuffles, one warp over the 32 warp totals, a running carry, as in
// pack.cu), each thread stores its group's bytes at its offset, and the
// tail past the total is zero-filled.  The CTA stops at the first tile that
// starts past the budget.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
static_assert(kWarps == 32, "the second scan level is one warp wide");

__global__ void __launch_bounds__(kThreads)
emit_kernel(const uint32_t* __restrict__ gw, const uint32_t* __restrict__ gc4,
            uint8_t* __restrict__ out, int NG, int OUTW) {
  __shared__ int warp_incl[kWarps];
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long cap = 4LL * OUTW;
  const uint32_t* gb = gw + (size_t)b * NG;
  const uint32_t* cb = gc4 + (size_t)b * (NG / 4);
  uint8_t* ob = out + (size_t)b * cap;

  long long carry = 0;  // bytes before the current tile, same in every thread
  for (int base = 0; base < NG && carry < cap; base += kThreads) {
    const int g = base + threadIdx.x;
    int c = 0;
    if (g < NG) c = static_cast<int>((cb[g >> 2] >> (8 * (g & 3))) & 255u);
    int x = c;  // inclusive scan within the warp
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
    const long long off =
        carry + (warp > 0 ? warp_incl[warp - 1] : 0) + x - c;
    if (c > 0) {
      const uint32_t w = gb[g];
      for (int i = 0; i < c && off + i < cap; ++i) {
        ob[off + i] = i < 4 ? static_cast<uint8_t>(w >> (24 - 8 * i)) : 0;
      }
    }
    carry += warp_incl[kWarps - 1];
    __syncthreads();  // warp_incl is rewritten by the next tile
  }
  for (long long i = (carry < cap ? carry : cap) + threadIdx.x; i < cap;
       i += kThreads) {
    ob[i] = 0;
  }
}

}  // namespace

// gw (B, NG) u32, gc4 (B, NG/4) u32 -> out (B, 4 OUTW) u8.
extern "C" int huff_emit(const void* gw, const void* gc4, void* out, int B,
                         int NG, int OUTW, void* stream) {
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  if (NG % 4 || OUTW <= 0) return static_cast<int>(cudaErrorInvalidValue);
  emit_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(gw), static_cast<const uint32_t*>(gc4),
      static_cast<uint8_t*>(out), NG, OUTW);
  return static_cast<int>(cudaGetLastError());
}
