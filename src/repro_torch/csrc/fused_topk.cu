// Stage-1 INT4 scoring fused with a per-block top-k on Hopper.
//
// Replaces the Pallas TPU kernels
//   src/repro/kernels/fused_topk.py  fused_topk_batched_pallas
//   and, at B = 1, fused_topk_pallas (the single-query, unmasked form)
//
// For each block of block_n plane rows and each query lane the kernel
// scores the rows exactly as the plane scan does (nibble.cuh: __dp4a on
// pre-shifted nibble words), keeps the block's (lanes x block_n) int32
// scores in shared memory, never in device memory, optionally masks them
// with the lane's tenant (owner[row] == tid && tid >= 0, else INT32_MIN),
// and emits the block's top-k (score, global row id) per lane.
//
// Selection reproduces the reference's iterative argmax bit for bit: each
// pick is the largest score, ties toward the lower row, and the picked
// entry becomes INT32_MIN. Once a block has no live (non-INT32_MIN) entry
// left, argmax over an all-INT32_MIN block returns index 0, so every
// further pick is (INT32_MIN, block base) and the same id repeats (a fully
// masked block, a padding lane with tid < 0, k above the live rows or
// above block_n). In closed form: the first L = min(k, live) picks are the
// live entries in descending (score, -row) order, the rest (INT32_MIN,
// base). One warp serves one lane at a time: k rounds, each taking the
// warp maximum of the packed keys (score << 32 | ~row, unique per row)
// below the previous pick.
//
// Ragged N: the reference wrapper pads the plane with zero rows to a
// block multiple. Here a row at or past N is such a zero row without a
// read: it scores 0 (owner -1 when masked), carries its padded id >= N,
// and may take a slot from a real row with a negative score. The output
// (B, ceil(N / block_n), k) therefore equals the Pallas kernel's on the
// padded plane, and nothing is padded or copied.
//
// Widths: every even D (nibble.cuh's read modes). The lanes' panels walk
// through shared memory kSpanWords words per half at a time, so any D is
// served by one code path (D <= 1024 takes one pass).
//
// What bounds it on an H100 at N = 2^20, D = 512, B = 32, block_n = 512,
// k = 8: it reads the 256 MiB plane once and writes 2 x (32 x 2048 x 8)
// int32 (4 MiB), about 80 us at 3.35 TB/s; its scoring is the plane scan's
// dp4a work (34 G int8 operations on the integer pipe), which bounds it
// above the byte bound, as it does the plane kernel. Design: a block of
// 256 threads owns one row block for a tile of up to BT = 32 lanes (grid.x
// walks row blocks, grid.y lane tiles); each thread scores block_n / 256
// rows against every lane of the tile, reusing each 64-byte row chunk in
// registers. The (B, N) score matrix and the top-k pass over it that the
// plane kernel leaves to its caller never touch device memory.

#include "nibble.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSpanWords = 128;  // panel words per lane half per pass
constexpr int kInt32Min = -2147483647 - 1;
constexpr long long kNoKey = -9223372036854775807LL - 1;  // below every key

// q_eo (B, 2, D2) int8 lane panels; plane (N, D2) uint8; owner (N,) int32
// and tids (B,) int32, or owner null for no mask; out_s, out_i (B, nb, k)
// int32 with nb = gridDim.x. span: panel words per half held at a time (a
// multiple of 16). Shared memory: the panels [2][BT][span] words, then the
// scores [BT][block_n].
template <int BT, int MODE, bool TAIL>
__global__ void __launch_bounds__(kThreads)
fused_kernel(const int8_t* __restrict__ q_eo,
             const uint8_t* __restrict__ plane,
             const int32_t* __restrict__ owner,
             const int32_t* __restrict__ tids,
             int32_t* __restrict__ out_s, int32_t* __restrict__ out_i, int B,
             long long N, int D2, int block_n, int k, int span) {
  extern __shared__ uint4 smem[];
  uint32_t* q_s = reinterpret_cast<uint32_t*>(smem);
  int32_t* s_s = reinterpret_cast<int32_t*>(q_s + 2 * BT * span);
  const int words = (D2 + 3) / 4;
  const int full = D2 / 4 / kChunkWords * kChunkWords;
  const int b0 = blockIdx.y * BT;
  const long long base = static_cast<long long>(blockIdx.x) * block_n;

  for (int i = threadIdx.x; i < BT * block_n; i += kThreads) s_s[i] = 0;
  for (int c0 = 0; c0 < words; c0 += span) {
    __syncthreads();  // scores zeroed, previous span consumed
    for (int i = threadIdx.x; i < 2 * BT * span; i += kThreads) {
      const int half = i / (BT * span);
      const int b = (i / span) % BT;
      const int w = c0 + i % span;
      q_s[i] = (b0 + b < B && w < words)
          ? operand_word<MODE>(q_eo, 2 * static_cast<size_t>(b0 + b) + half,
                               w, D2)
          : 0u;
    }
    __syncthreads();
    const int end = min(c0 + span, full);
    for (int r = threadIdx.x; r < block_n; r += kThreads) {
      const long long row = base + r;
      if (row >= N) continue;  // a padding row: zero bytes, score 0
      const uint8_t* rowp = plane + static_cast<size_t>(row) * D2;
      int acc[BT];
#pragma unroll
      for (int b = 0; b < BT; ++b) acc[b] = 0;
      for (int c = c0; c < end; c += kChunkWords) {
        int lo[kChunkWords], hi[kChunkWords];
        load_chunk<MODE, false>(rowp, c, D2, lo, hi);
        dot_chunk<BT>(q_s, span, c - c0, lo, hi, acc);
      }
      if constexpr (TAIL) {
        if (full >= c0 && full < c0 + span) {
          int lo[kChunkWords], hi[kChunkWords];
          load_chunk<MODE, true>(rowp, full, D2, lo, hi);
          dot_chunk<BT>(q_s, span, full - c0, lo, hi, acc);
        }
      }
#pragma unroll
      for (int b = 0; b < BT; ++b) s_s[b * block_n + r] += acc[b];
    }
  }
  __syncthreads();

  // Exact scores, with the lane's tenant mask applied in shared memory.
  for (int i = threadIdx.x; i < BT * block_n; i += kThreads) {
    const int b = i / block_n;
    const long long row = base + i % block_n;
    int v = s_s[i] >> 4;
    if (owner != nullptr) {
      const int t = b0 + b < B ? tids[b0 + b] : -1;
      const int own = row < N ? owner[row] : -1;
      if (own != t || t < 0) v = kInt32Min;
    }
    s_s[i] = v;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int b = warp; b < BT && b0 + b < B; b += kWarps) {
    const int32_t* sc = s_s + b * block_n;
    const size_t o = (static_cast<size_t>(b0 + b) * gridDim.x + blockIdx.x)
                     * k;
    long long last = 9223372036854775807LL;
    for (int j = 0; j < k; ++j) {
      long long best = kNoKey;
      if (last != kNoKey) {
        for (int r = lane; r < block_n; r += 32) {
          const int v = sc[r];
          if (v == kInt32Min) continue;
          const long long key = static_cast<long long>(v) * 4294967296LL
                                + static_cast<unsigned int>(~r);
          if (key < last && key > best) best = key;
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          const long long other = __shfl_xor_sync(0xffffffffu, best, off);
          best = other > best ? other : best;
        }
      }
      if (lane == 0) {
        if (best == kNoKey) {
          out_s[o + j] = kInt32Min;
          out_i[o + j] = static_cast<int32_t>(base);
        } else {
          out_s[o + j] = static_cast<int32_t>(best >> 32);
          out_i[o + j] = static_cast<int32_t>(
              base + ~static_cast<unsigned int>(best));
        }
      }
      last = best;
    }
  }
}

struct FusedArgs {
  const int8_t* q;
  const uint8_t* plane;
  const int32_t* owner;
  const int32_t* tids;
  int32_t* out_s;
  int32_t* out_i;
  int B;
  long long N;
  int D2;
  int block_n;
  int k;
  int span;
  cudaStream_t stream;
};

size_t fused_smem(int bt, const FusedArgs& a) {
  return static_cast<size_t>(bt) * (2 * a.span + a.block_n) * 4;
}

template <int BT, int MODE, bool TAIL>
cudaError_t launch_fused(const FusedArgs& a) {
  const size_t smem = fused_smem(BT, a);
  const cudaError_t err = allow_smem(fused_kernel<BT, MODE, TAIL>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((a.N + a.block_n - 1) / a.block_n),
                  static_cast<unsigned>((a.B + BT - 1) / BT));
  fused_kernel<BT, MODE, TAIL><<<grid, kThreads, smem, a.stream>>>(
      a.q, a.plane, a.owner, a.tids, a.out_s, a.out_i, a.B, a.N, a.D2,
      a.block_n, a.k, a.span);
  return cudaGetLastError();
}

template <int MODE, bool TAIL>
cudaError_t launch_fused_tile(int bt, const FusedArgs& a) {
  switch (bt) {
    case 1: return launch_fused<1, MODE, TAIL>(a);
    case 2: return launch_fused<2, MODE, TAIL>(a);
    case 4: return launch_fused<4, MODE, TAIL>(a);
    case 8: return launch_fused<8, MODE, TAIL>(a);
    case 16: return launch_fused<16, MODE, TAIL>(a);
    default: return launch_fused<32, MODE, TAIL>(a);
  }
}

}  // namespace

// q_eo (B, 2, D2) int8; plane (N, D2) uint8; owner (N,) / tids (B,) int32
// or owner null (unmasked); out_s, out_i (B, ceil(N / block_n), k) int32.
extern "C" int fused_topk_launch(const void* q_eo, const void* plane,
                                 const void* owner, const void* tids,
                                 void* out_s, void* out_i, int B, long long N,
                                 int D2, int block_n, int k, void* stream) {
  if (block_n < 1 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  FusedArgs a{static_cast<const int8_t*>(q_eo),
              static_cast<const uint8_t*>(plane),
              static_cast<const int32_t*>(owner),
              static_cast<const int32_t*>(tids),
              static_cast<int32_t*>(out_s), static_cast<int32_t*>(out_i),
              B, N, D2, block_n, k, 0, static_cast<cudaStream_t>(stream)};
  const long long words_pad = round_up((D2 + 3) / 4, kChunkWords);
  a.span = static_cast<int>(words_pad < kSpanWords ? words_pad : kSpanWords);
  // The smallest power-of-two lane tile that covers B (at most 32), halved
  // while its panels and scores exceed the shared memory of one block.
  int bt = 1;
  while (bt < B && bt < 32) bt *= 2;
  while (bt > 1 && fused_smem(bt, a) > static_cast<size_t>(kMaxSmem)) bt /= 2;
  if (fused_smem(bt, a) > static_cast<size_t>(kMaxSmem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int mode = mode_for(D2);
  cudaError_t err;
  if (D2 % 64 == 0) err = launch_fused_tile<kVec, false>(bt, a);
  else if (mode == kVec) err = launch_fused_tile<kVec, true>(bt, a);
  else if (mode == kWord) err = launch_fused_tile<kWord, true>(bt, a);
  else err = launch_fused_tile<kByte, true>(bt, a);
  return static_cast<int>(err);
}
