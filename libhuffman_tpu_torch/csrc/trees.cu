// K7: each block's Huffman tree and codewords for the encode path.
//
// Replaces no Pallas kernel: the JAX package builds its trees in XLA
// (libhuffman_tpu/ops/device.py:187 build_trees, 256 fixed merge rounds,
// and :264 extract_codes, a 32-step walk), and the port's plain-torch
// twins of those (ops/device.build_trees, extract_codes) enqueue about 36
// small torch ops per merge round, thousands a batch, and read the round
// count back to the host.  This kernel does a batch in one launch.
//
// Contract: freqs (B, 512) i32, each row's byte counts in slots 0..255 with
// a sum below 2^31 (slots 256..511 are not read; the histogram leaves them
// zero) ->
//   left, right (B, 512) i32: the children of node 256 + r made in merge
//     round r, -1 elsewhere (leaves, unused nodes, the unary root's right);
//   root (B,) i32: the unary root, -1 for an all-zero row;
//   codes (B, 256) u32: each symbol's MSB-first codeword, right-aligned;
//   lens (B, 256) i32: its length (0 for an absent symbol);
//   ovf (B,) u8: a leaf does not reach the root within 32 steps (its code
//     and length are cut at 32 bits, as the twin cuts them);
//   total_bits (B,) i64: the sum of freq x len over the 256 symbols.
// The tie-break is the reference's (src/tree.c:318-414): each round merges
// the two live slots of least (rate, then largest slot) into node 256 + r,
// the first as left child; the sole survivor is wrapped in a parent with
// only a left child, the unary root.  Every output word is written.
//
// Bound on the H100: the latency of the round chain, not bytes.  A row of
// k symbols is k dependent rounds (k - 1 merges and the wrap), up to 256,
// each two dependent arg-minimums over the row's live slots; a 1024-row
// batch reads 2 MiB and writes 8 MiB, 3 us at 3.35 TB/s.  Design: one warp
// per row, kRows rows per CTA, so a whole batch is resident at once and
// its rows' chains run side by side.  Lane l keeps the rates of slots
// 32 j + l (j < 16) in registers; a round is one scan of its 16 rates for
// its two least (rate, slot) pairs, then per arg-minimum two warp
// reductions (__reduce_min_sync of the rate, __reduce_max_sync of the
// slot among the lanes holding that rate), the owner of the first minimum
// offering its second pair to the next.  Node 256 + r lives in lane r % 32,
// which also keeps its children in registers.  Each slot's parent and
// branch bit go to shared memory (2 bytes a slot), where the walk reads
// them: each lane walks its 8 leaves together, and the warp stops when no
// leaf has a parent left.  A row stops at its own last round, so no round
// count crosses to the host.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 4;                 // rows (warps) per CTA
constexpr int kThreads = 32 * kRows;
constexpr int kSlots = 512;              // 256 leaves, 256 internal nodes
constexpr int kPerLane = kSlots / 32;    // slot 32 j + lane, j < 16
constexpr int kLeavesPerLane = 256 / 32;
constexpr int kMaxBits = 32;             // the device fast path's code limit
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr uint32_t kDead = 0xFFFFFFFFu;  // rate of an empty or merged slot

// The warp's least (rate, largest slot) over the lanes' candidates; the
// slot is -1 when every rate is kDead.
__device__ __forceinline__ void warp_argmin(uint32_t rate, int slot,
                                            uint32_t& m, int& s) {
  m = __reduce_min_sync(kFull, rate);
  const unsigned c =
      (rate == m && m != kDead) ? static_cast<unsigned>(slot) + 1u : 0u;
  s = static_cast<int>(__reduce_max_sync(kFull, c)) - 1;
}

__global__ void __launch_bounds__(kThreads)
trees_kernel(const int32_t* __restrict__ freqs, int32_t* __restrict__ left,
             int32_t* __restrict__ right, int32_t* __restrict__ root,
             uint32_t* __restrict__ codes, int32_t* __restrict__ lens,
             uint8_t* __restrict__ ovf, int64_t* __restrict__ total_bits,
             int B) {
  // (parent + 1) | branch bit << 10 of each slot; 0: no parent.
  __shared__ uint16_t pp_all[kRows][kSlots];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kRows + warp;
  if (b >= B) return;  // the whole warp; the CTA never synchronises
  uint16_t* pp = pp_all[warp];
  const int32_t* f = freqs + static_cast<size_t>(b) * kSlots;

  uint32_t rate[kPerLane];
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int32_t v = j < 8 ? f[32 * j + lane] : 0;
    rate[j] = v > 0 ? static_cast<uint32_t>(v) : kDead;
    pp[32 * j + lane] = 0;
  }
  // Children of this lane's nodes 256 + 32 j + lane.
  int32_t lft[8], rgt[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) lft[j] = rgt[j] = -1;
  int rt = -1;
  __syncwarp();

  for (int r = 0; r < 256; ++r) {
    // This lane's two least (rate, largest slot): slots rise with j, so
    // `<=` lets the later slot win a tie.
    uint32_t r1 = kDead, r2 = kDead;
    int j1 = 0, j2 = 0;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const uint32_t v = rate[j];
      if (v <= r1) {
        r2 = r1; j2 = j1; r1 = v; j1 = j;
      } else if (v <= r2) {
        r2 = v; j2 = j;
      }
    }
    uint32_t m1, m2;
    int s1, s2;
    warp_argmin(r1, 32 * j1 + lane, m1, s1);
    if (s1 < 0) break;  // an all-zero row: no live slot
    const bool own1 = (s1 & 31) == lane;
    warp_argmin(own1 ? r2 : r1, 32 * (own1 ? j2 : j1) + lane, m2, s2);
    const int node = 256 + r;
    const bool mine = (r & 31) == lane;
    const int nj = r >> 5;
    // Retire s1 (and s2); node 256 + r takes their sum, unless it wraps.
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      if ((own1 && j == (s1 >> 5)) ||
          (s2 >= 0 && (s2 & 31) == lane && j == (s2 >> 5))) {
        rate[j] = kDead;
      }
      if (s2 >= 0 && mine && j == 8 + nj) rate[j] = m1 + m2;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (mine && j == nj) {
        lft[j] = s1;
        if (s2 >= 0) rgt[j] = s2;
      }
    }
    if (lane == 0) {
      pp[s1] = static_cast<uint16_t>(node + 1);
      if (s2 >= 0) pp[s2] = static_cast<uint16_t>((node + 1) | (1 << 10));
    }
    if (s2 < 0) {  // the sole survivor: the unary root wraps it
      rt = node;
      break;
    }
  }

  int32_t* lrow = left + static_cast<size_t>(b) * kSlots;
  int32_t* rrow = right + static_cast<size_t>(b) * kSlots;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    lrow[32 * j + lane] = j < 8 ? -1 : lft[j - 8];
    rrow[32 * j + lane] = j < 8 ? -1 : rgt[j - 8];
  }
  __syncwarp();  // the parents written by lane 0 are seen by every lane

  // Walk leaf 32 j + lane toward the root: the t-th bit collected goes to
  // bit t, so the root-most bit ends highest (the MSB-first codeword).
  uint32_t code[kLeavesPerLane];
  int len[kLeavesPerLane], at[kLeavesPerLane];
#pragma unroll
  for (int j = 0; j < kLeavesPerLane; ++j) {
    code[j] = 0;
    len[j] = 0;
    at[j] = 32 * j + lane;
  }
  bool up = true;  // some leaf of this lane may still have a parent
  for (int t = 0; t < kMaxBits && __any_sync(kFull, up); ++t) {
    up = false;
#pragma unroll
    for (int j = 0; j < kLeavesPerLane; ++j) {
      const unsigned e = pp[at[j]];
      if (e & 0x3FF) {
        code[j] |= ((e >> 10) & 1u) << len[j];
        ++len[j];
        at[j] = static_cast<int>(e & 0x3FF) - 1;
        up = true;
      }
    }
  }
  bool deep = false;  // a leaf still below a parent after 32 steps
  long long bits = 0;
#pragma unroll
  for (int j = 0; j < kLeavesPerLane; ++j) {
    deep |= (pp[at[j]] & 0x3FF) != 0;
    bits += static_cast<long long>(f[32 * j + lane]) * len[j];
    codes[static_cast<size_t>(b) * 256 + 32 * j + lane] = code[j];
    lens[static_cast<size_t>(b) * 256 + 32 * j + lane] = len[j];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) bits += __shfl_xor_sync(kFull, bits, o);
  deep = __any_sync(kFull, deep);
  if (lane == 0) {
    root[b] = rt;
    ovf[b] = deep;
    total_bits[b] = bits;
  }
}

}  // namespace

extern "C" int huff_trees(const void* freqs, void* left, void* right,
                          void* root, void* codes, void* lens, void* ovf,
                          void* total_bits, int B, void* stream) {
  if (B > 0) {
    trees_kernel<<<(B + kRows - 1) / kRows, kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(freqs), static_cast<int32_t*>(left),
        static_cast<int32_t*>(right), static_cast<int32_t*>(root),
        static_cast<uint32_t*>(codes), static_cast<int32_t*>(lens),
        static_cast<uint8_t*>(ovf), static_cast<int64_t*>(total_bits), B);
  }
  return static_cast<int>(cudaGetLastError());
}
