// Stage-2 exact INT8 rescore of stage-1 candidates on Hopper.
//
// Replaces the Pallas TPU kernels
//   src/repro/kernels/stage2_int8.py  stage2_int8_batched_pallas
//   and, at B = 1, stage2_int8_pallas (the single-query form)
//
// out[b, c] = sum_d q[b, d] * v[b, c, d], where each INT8 value v is rebuilt
// from its packed MSB and LSB nibble planes. No nibble is unpacked: the
// original byte is (msb_nibble << 4) | lsb_nibble, so for plane words m and
// l the even-dim word is ((m & 0x0F0F0F0F) << 4) | (l & 0x0F0F0F0F) and the
// odd-dim word is (m & 0xF0F0F0F0) | ((l >> 4) & 0x0F0F0F0F); each goes
// through __dp4a with the query's even or odd int8 word. Every even D is
// served: rows of D/2 bytes are read in 32-bit words when D/2 % 4 == 0 and
// byte by byte otherwise (the bytes of the last word past D/2 read as
// zero in every operand); the warp's strided word loop masks the last
// partial round itself.
//
// Two forms, one body. By id (the engine's): candidate (b, c) is row
// ids[b, c] of the full (N, D/2) planes, clamped to [0, N - 1] as JAX's
// indexing (x[ids]) clamps, read in place; the reference engine's jnp.take
// fills instead, and the engine never passes an id >= N. Gathered (the
// reference's interface, and the single-query form): row b * C + c of
// (B * C, D/2) rows the caller copied out.
//
// What bounds it on an H100 at B = 32, C = 50, D = 512: it reads
// 2 * B * C * D/2 = 800 KiB of candidate rows, under a microsecond of
// memory time; its body runs in about 1.7 us, the launch floor, so the
// host work around it bounds it. Design: one warp per (lane, candidate)
// row; the 32 threads read consecutive 4-byte words of both planes
// (coalesced 128-byte requests), dp4a them against the lane's query words
// and reduce with warp shuffles. Reading by id saves the engine the two
// (B, C, D/2) index gathers it launched before this kernel.

#include "nibble.cuh"

namespace {

constexpr int kThreads = 256;  // 8 rows (warps) per block

// q_eo8 (B, 2, D2) int8; out (B, C) int32. With ids (B, C) int32,
// msb/lsb are the (N, D2) planes and candidate row is clamp(id, 0, N - 1);
// with ids null, msb/lsb are (B * C, D2) gathered rows. MODE kWord
// (D2 % 4 == 0) or kByte (any D2).
template <int MODE>
__global__ void __launch_bounds__(kThreads)
exact_kernel(const int8_t* __restrict__ q_eo8,
             const uint8_t* __restrict__ msb,
             const uint8_t* __restrict__ lsb,
             const int32_t* __restrict__ ids,
             int32_t* __restrict__ out, long long rows, int C, int D2,
             long long N) {
  const long long row = (static_cast<long long>(blockIdx.x) * kThreads
                         + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // uniform across the warp
  const long long b = row / C;
  long long src = row;
  if (ids != nullptr) {
    src = ids[row];
    src = src < 0 ? 0 : (src >= N ? N - 1 : src);
  }
  const int words = (D2 + 3) / 4;
  const uint8_t* mrow = msb + static_cast<size_t>(src) * D2;
  const uint8_t* lrow = lsb + static_cast<size_t>(src) * D2;
  const uint8_t* qrow = reinterpret_cast<const uint8_t*>(q_eo8)
                        + static_cast<size_t>(b) * 2 * D2;
  const uint32_t* m = reinterpret_cast<const uint32_t*>(mrow);
  const uint32_t* l = reinterpret_cast<const uint32_t*>(lrow);
  const uint32_t* qe = reinterpret_cast<const uint32_t*>(qrow);
  const uint32_t* qo = qe + words;
  int s = 0;
#pragma unroll 2
  for (int w = lane; w < words; w += 32) {
    uint32_t mw, lw, ew, ow;
    if constexpr (MODE == kByte) {
      mw = byte_word(mrow, w, D2);
      lw = byte_word(lrow, w, D2);
      ew = byte_word(qrow, w, D2);
      ow = byte_word(qrow + D2, w, D2);
    } else {
      mw = __ldg(m + w);
      lw = __ldg(l + w);
      ew = __ldg(qe + w);
      ow = __ldg(qo + w);
    }
    const uint32_t even = ((mw & 0x0F0F0F0Fu) << 4) | (lw & 0x0F0F0F0Fu);
    const uint32_t odd = (mw & 0xF0F0F0F0u) | ((lw >> 4) & 0x0F0F0F0Fu);
    s = __dp4a(static_cast<int>(even), static_cast<int>(ew), s);
    s = __dp4a(static_cast<int>(odd), static_cast<int>(ow), s);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
  if (lane == 0) out[row] = s;
}

}  // namespace

// ids null: msb/lsb are (B * C, D2) gathered rows (n unused); else
// (n, D2) planes read at the (B, C) int32 ids.
extern "C" int stage2_exact_launch(const void* q_eo8, const void* msb,
                                   const void* lsb, const void* ids,
                                   void* out, int B, int C, int D2,
                                   long long n, void* stream) {
  const long long rows = static_cast<long long>(B) * C;
  const long long warps_per_block = kThreads / 32;
  const unsigned blocks = static_cast<unsigned>(
      (rows + warps_per_block - 1) / warps_per_block);
  const auto* q = static_cast<const int8_t*>(q_eo8);
  const auto* m = static_cast<const uint8_t*>(msb);
  const auto* l = static_cast<const uint8_t*>(lsb);
  const auto* id = static_cast<const int32_t*>(ids);
  auto* o = static_cast<int32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (D2 % 4 == 0) {
    exact_kernel<kWord><<<blocks, kThreads, 0, s>>>(q, m, l, id, o, rows, C,
                                                    D2, n);
  } else {
    exact_kernel<kByte><<<blocks, kThreads, 0, s>>>(q, m, l, id, o, rows, C,
                                                    D2, n);
  }
  return static_cast<int>(cudaGetLastError());
}
