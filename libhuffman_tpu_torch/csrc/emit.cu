// K4: the decoded bytes of each block, from the chain's group words.
//
// Replaces libhuffman_tpu/ops/concat_kernel.py:340 concat_groups_ovf
// (pallas_call at :362, body _concat_kernel_body at :140-270 with packed
// counts), fed by decode_v3.py:414-475 _emit_from_chain: a bit-reversed
// halving merge tree over the group strings in VMEM, with a capacity clamp
// (ECW) that flags blocks it cannot hold.  The TPU's caller live-masks the
// counts first (decode_v3.py:540-549); here that mask is K4's own.
//
// Contract: gw (B, NG) u32 left-aligned group words, gc4 (B, NG/4) u32
// packed counts (byte k of word j = count of group 4 j + k), gr32 (B, NG/4)
// u32 running totals of those counts (starts through stripe j), n_cap (B,)
// i32 live groups, OUTW -> out (B, 4 OUTW) u8: the strings of groups
// 0 .. min(n_cap, NG) - 1 joined in group order, cut at 4 OUTW bytes and
// zero-filled past their total.  Group g's string is its count c of bytes,
// byte i being byte i of gw from the top for i < 4 and zero past it.  Every
// output byte is written exactly once.  No clamp, so no overflow flag:
// bytes past 4 OUTW are dropped (they lie past n_sym).
//
// Bound on the H100: it reads 4 bytes of counts per 4 groups and 4 bytes
// per live group, and writes each output byte once: 38.9 MB for the
// 128-block plan of an 8 MiB text prefix (NG = 49152, OUTW = 16384), 12 us
// at 3.35 TB/s.
//
// Design: a 1-D grid of (block, tile of kTile = 2048 groups), so the grid
// fills the card whatever B is.  A tile's first byte is at gr32[b, 4 t' - 1]
// (the chain's running total before it), so no scan crosses tiles; a tile
// at or past n_cap emits nothing, and the one that holds n_cap masks its
// later counts.  Inside a tile each of 256 threads takes 8 groups (two count
// words, two 16-byte loads of group words), every load of the CTA issued
// before the first is used; one scan of the 256 thread
// sums gives each thread its offset; the bytes are assembled in shared
// memory at the output's alignment and leave in 16-byte stores by
// neighbouring lanes, only the two ragged ends byte by byte.  The zero fill
// past the live total is split evenly over the block's tiles.
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W): see PERF.md §6.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 8;                  // groups per thread, a multiple of 4
constexpr int kTile = kThreads * kPer;   // groups per CTA
constexpr int kBuf = 8 * kTile + 16;     // a group holds at most 8 starts

// Bytes [lo, hi) of row `row`: byte o from src[skew + o - lo], where skew is
// the address of row + lo mod 16, or zero when src is null.  Neighbouring
// threads store neighbouring 16-byte chunks; the ragged ends go byte by
// byte.
__device__ __forceinline__ void write_range(uint8_t* row, long long lo,
                                            long long hi, const uint8_t* src) {
  if (lo >= hi) return;
  const int skew = static_cast<int>(reinterpret_cast<uintptr_t>(row + lo) & 15);
  const long long n = hi - lo;
  const long long head = min(static_cast<long long>((16 - skew) & 15), n);
  const long long body = (n - head) & ~15LL;
  uint8_t* d = row + lo;
  for (long long i = threadIdx.x; i < head; i += kThreads)
    d[i] = src ? src[skew + i] : 0;
  for (long long i = head + body + threadIdx.x; i < n; i += kThreads)
    d[i] = src ? src[skew + i] : 0;
  uint4* d4 = reinterpret_cast<uint4*>(d + head);
  const uint4* s4 = src ? reinterpret_cast<const uint4*>(src + skew + head)
                        : nullptr;
  for (long long q = threadIdx.x; q < body / 16; q += kThreads)
    d4[q] = s4 ? s4[q] : make_uint4(0u, 0u, 0u, 0u);
}

__global__ void __launch_bounds__(kThreads)
emit_kernel(const uint32_t* __restrict__ gw, const uint32_t* __restrict__ gc4,
            const uint32_t* __restrict__ gr32, const int* __restrict__ n_cap,
            uint8_t* __restrict__ out, int NG, int OUTW, int T) {
  __shared__ __align__(16) uint8_t buf[kBuf];
  __shared__ int warp_sum[kWarps];
  const long long b = blockIdx.x / T;
  const int t = static_cast<int>(blockIdx.x % T);
  const int NC = NG / 4;
  const long long cap = 4LL * OUTW;
  const uint32_t* cb = gc4 + b * NC;
  const uint32_t* rb = gr32 + b * NC;
  uint8_t* ob = out + b * cap;
  const int gcap = min(max(n_cap[b], 0), NG);
  const int g0 = t * kTile;
  const int g = g0 + kPer * threadIdx.x;  // this thread's first group

  // Every other load of the CTA is issued here, before any is used: the
  // live total (the offset of group gcap), the tile's first offset, and
  // this thread's count cells and group words, the last two whether or
  // not the tile turns out to lie past gcap, so that they need not wait
  // for n_cap.
  long long live = gcap >= 4 ? rb[gcap / 4 - 1] : 0;
  const uint32_t cap_cell = gcap & 3 ? cb[gcap / 4] : 0u;
  const bool emits = g0 < gcap;
  uint32_t cnt[kPer / 4];                    // count cells
  uint4 gv[kPer / 4];                        // group words
#pragma unroll
  for (int c = 0; c < kPer / 4; ++c) {
    cnt[c] = 0u;
    gv[c] = make_uint4(0u, 0u, 0u, 0u);
  }
  const long long o0 = g0 ? rb[g0 / 4 - 1] : 0;
  const uint4* g4 = reinterpret_cast<const uint4*>(gw + b * NG + g);
#pragma unroll
  for (int c = 0; c < kPer / 4; ++c) {
    if (g + 4 * c < NG) {
      cnt[c] = cb[g / 4 + c];
      gv[c] = g4[c];
    }
  }
  for (int k = 0; k < (gcap & 3); ++k) live += (cap_cell >> (8 * k)) & 255u;
  const long long end = min(live, cap);

  if (emits) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    // Mask the groups at or past gcap.
#pragma unroll
    for (int k = 0; k < kPer; ++k)
      if (g + k >= gcap) cnt[k >> 2] &= ~(255u << (8 * (k & 3)));
    // The sum of the count bytes.
    int mine = 0;
#pragma unroll
    for (int c = 0; c < kPer / 4; ++c)
      mine = static_cast<int>(
          __dp4a(cnt[c], 0x01010101u, static_cast<unsigned>(mine)));
    int incl = mine;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, incl, d);
      if (lane >= d) incl += y;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    int before = incl - mine, total = 0;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) {
      const int s = warp_sum[i];
      before += i < warp ? s : 0;
      total += s;
    }
    const int skew =
        static_cast<int>(reinterpret_cast<uintptr_t>(ob + o0) & 15);
    if (mine) {
      uint8_t* p = buf + skew + before;
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int n = static_cast<int>((cnt[k >> 2] >> (8 * (k & 3))) & 255u);
        const uint4& v = gv[k >> 2];
        const uint32_t w = (k & 3) == 0 ? v.x : (k & 3) == 1 ? v.y
                         : (k & 3) == 2 ? v.z : v.w;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (i < n) p[i] = static_cast<uint8_t>(w >> (24 - 8 * i));
        for (int i = 4; i < n; ++i) p[i] = 0;
        p += n;
      }
    }
    __syncthreads();
    write_range(ob, o0, min(o0 + total, cap), buf);
  }

  // This tile's share of the zero fill [end, cap).
  const long long share = ((cap - end + T - 1) / T + 15) & ~15LL;
  const long long z0 = end + t * share;
  write_range(ob, z0, min(z0 + share, cap), nullptr);
}

}  // namespace

// gw (B, NG) u32 (16-byte aligned), gc4 and gr32 (B, NG/4) u32, n_cap (B,)
// i32 -> out (B, 4 OUTW) u8, every byte written.
extern "C" int huff_emit(const void* gw, const void* gc4, const void* gr32,
                         const void* n_cap, void* out, int B, int NG, int OUTW,
                         void* stream) {
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  if (NG <= 0 || NG % 4 || OUTW <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(gw) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const int T = (NG + kTile - 1) / kTile;
  const long long grid = static_cast<long long>(B) * T;
  if (grid > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  emit_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(gw), static_cast<const uint32_t*>(gc4),
      static_cast<const uint32_t*>(gr32), static_cast<const int*>(n_cap),
      static_cast<uint8_t*>(out), NG, OUTW, T);
  return static_cast<int>(cudaGetLastError());
}
