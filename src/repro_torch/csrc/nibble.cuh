// Device helpers shared by the port's kernels: the MSB-nibble (INT4)
// plane, rows and gather scans (stage1_plane.cuh, stage1_rows.cu) and the
// fused score + per-block top-k (fused_topk.cu) use all of them; the exact
// rescore (stage2_int8.cu) and the sign scans (stage0_sign.cu) read rows
// that are not whole words with byte_word and opt into shared memory with
// allow_smem.
//
// Packed rows hold D/2 bytes (byte j: dim 2j in the low nibble, dim 2j+1
// in the high nibble, raw two's complement). No nibble is unpacked: for a
// row word w, (w << 4) & 0xF0F0F0F0 holds 16 * sext4(lo) in each signed
// byte and w & 0xF0F0F0F0 holds 16 * sext4(hi), so __dp4a against the
// query's even and odd nibble words sums 16 * score, and an arithmetic
// shift right by 4 is exact.
//
// Row read modes: kVec reads 16 bytes at a time (rows 16-byte aligned,
// D/2 % 16 == 0), kWord 32-bit words (D/2 % 4 == 0), kByte single bytes
// for any D/2 (rows are then not word aligned). In kByte a row has
// ceil(D/2 / 4) words and the bytes of its last word at or past D/2 read
// as zero, in the row and in the query panel alike.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunkWords = 16;    // 64 row bytes per register chunk
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxSmem = 232448;   // Hopper's opt-in shared memory per block

enum Mode { kVec = 0, kWord = 1, kByte = 2 };

// The read mode for rows of d2 bytes.
inline int mode_for(long long d2) {
  return d2 % 16 == 0 ? kVec : (d2 % 4 == 0 ? kWord : kByte);
}

inline long long round_up(long long x, long long m) {
  return (x + m - 1) / m * m;
}

__device__ __forceinline__ int lo16(uint32_t w) {
  return static_cast<int>((w << 4) & 0xF0F0F0F0u);
}

__device__ __forceinline__ int hi16(uint32_t w) {
  return static_cast<int>(w & 0xF0F0F0F0u);
}

// Word w of a d2-byte row read byte by byte; bytes at or past d2 are zero.
__device__ __forceinline__ uint32_t byte_word(const uint8_t* __restrict__ row,
                                              int w, int d2) {
  uint32_t x = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int j = 4 * w + i;
    if (j < d2) x |= static_cast<uint32_t>(__ldg(row + j)) << (8 * i);
  }
  return x;
}

// Word w of row `r` of a packed operand with d2 bytes per row (a query
// panel): a 32-bit read in the word modes, assembled from bytes in kByte.
template <int MODE>
__device__ __forceinline__ uint32_t operand_word(const void* base, size_t r,
                                                 int w, int d2) {
  if constexpr (MODE == kByte) {
    return byte_word(static_cast<const uint8_t*>(base) + r * d2, w, d2);
  } else {
    return static_cast<const uint32_t*>(base)[r * (d2 / 4) + w];
  }
}

// Loads words [c, c + 16) of a row as pre-shifted nibble words. MASKED:
// words at or past the row's end read as zero, which contributes nothing
// to the dot (kByte masks byte by byte in every chunk).
template <int MODE, bool MASKED>
__device__ __forceinline__ void load_chunk(const uint8_t* __restrict__ row,
                                           int c, int d2,
                                           int (&lo)[kChunkWords],
                                           int (&hi)[kChunkWords]) {
  const uint32_t* rowp = reinterpret_cast<const uint32_t*>(row);
  if constexpr (MODE == kVec && !MASKED) {
    const uint4* p = reinterpret_cast<const uint4*>(rowp + c);
#pragma unroll
    for (int v = 0; v < kChunkWords / 4; ++v) {
      const uint4 x = __ldg(p + v);
      lo[4 * v + 0] = lo16(x.x); hi[4 * v + 0] = hi16(x.x);
      lo[4 * v + 1] = lo16(x.y); hi[4 * v + 1] = hi16(x.y);
      lo[4 * v + 2] = lo16(x.z); hi[4 * v + 2] = hi16(x.z);
      lo[4 * v + 3] = lo16(x.w); hi[4 * v + 3] = hi16(x.w);
    }
  } else if constexpr (MODE == kByte) {
#pragma unroll
    for (int i = 0; i < kChunkWords; ++i) {
      const uint32_t x = byte_word(row, c + i, d2);
      lo[i] = lo16(x);
      hi[i] = hi16(x);
    }
  } else {
    const int words = d2 / 4;
#pragma unroll
    for (int i = 0; i < kChunkWords; ++i) {
      const uint32_t x = (!MASKED || c + i < words) ? __ldg(rowp + c + i) : 0u;
      lo[i] = lo16(x);
      hi[i] = hi16(x);
    }
  }
}

// acc[b] += 16 * (lane b's panel words [c, c + 16) . the loaded chunk).
// q_s: [2][BT][words_pad] (even panels, then odd).
template <int BT>
__device__ __forceinline__ void dot_chunk(const uint32_t* q_s, int words_pad,
                                          int c, const int (&lo)[kChunkWords],
                                          const int (&hi)[kChunkWords],
                                          int (&acc)[BT]) {
#pragma unroll
  for (int b = 0; b < BT; ++b) {
    const uint4* qe = reinterpret_cast<const uint4*>(q_s + b * words_pad + c);
    const uint4* qo = reinterpret_cast<const uint4*>(
        q_s + (BT + b) * words_pad + c);
    int s = acc[b];
#pragma unroll
    for (int v = 0; v < kChunkWords / 4; ++v) {
      const uint4 e = qe[v];
      const uint4 o = qo[v];
      s = __dp4a(lo[4 * v + 0], static_cast<int>(e.x), s);
      s = __dp4a(lo[4 * v + 1], static_cast<int>(e.y), s);
      s = __dp4a(lo[4 * v + 2], static_cast<int>(e.z), s);
      s = __dp4a(lo[4 * v + 3], static_cast<int>(e.w), s);
      s = __dp4a(hi[4 * v + 0], static_cast<int>(o.x), s);
      s = __dp4a(hi[4 * v + 1], static_cast<int>(o.y), s);
      s = __dp4a(hi[4 * v + 2], static_cast<int>(o.z), s);
      s = __dp4a(hi[4 * v + 3], static_cast<int>(o.w), s);
    }
    acc[b] = s;
  }
}

// Opts a kernel into more than the default 48 KiB of dynamic shared memory.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  if (smem <= static_cast<size_t>(kDefaultSmem)) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace
