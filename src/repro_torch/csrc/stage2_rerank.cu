// The engine's whole exact stage in one launch: exact INT8 rescore of each
// lane's candidates by id, their norms, the membership pins and the rerank.
//
// Replaces, together:
//   #3's by-id route (stage2_int8.cu's exact_kernel with an id table, the
//     port of src/repro/kernels/stage2_int8.py stage2_int8_batched_pallas)
//   and the reference's jnp stage around it, src/repro/core/engine.py
//   :910-952: the norms gather, the MASKED_SCORE / norm-1 pins, the
//   non-division cosine rerank (jax.vmap(similarity.rerank_dense_comparator),
//   src/repro/core/similarity.py:128-183) or jax.lax.top_k for MIPS, and
//   the result's masking.
// A second entry on the same body, `rerank`, is the ranking half alone, on
// (B, C) scores and norms already formed (the sharded index's final rerank
// after the owners' sum, src/repro/core/index.py).
//
// Ranking, exact and division-free. Cosine: a beats b when sign_a > sign_b
// (a zero norm counts as similarity 0), or the signs agree and are not 0
// and s_a^2 * max(n_b, 1) is above (both positive) or below (both
// negative) s_b^2 * max(n_a, 1). Those products reach 2^93: they are taken
// as 128-bit products of 64-bit operands (__umul64hi and the low word), so
// every int32 score, INT32_MIN included, is served. A candidate's wins
// are counted over all C; its rank is #{j : wins_j > wins_i, or wins_j ==
// wins_i and j < i}, which is the order of stable_topk(wins * C - i). MIPS
// ranks the raw scores by the same rule, the order of stable_topk: ties go
// to the lower index. Candidate i writes output position rank_i when it is
// below k. Every count is an integer: the order of the shared-memory
// atomics never changes a bit.
//
// What bounds it on an H100 at B = 32, C = 50, D = 512, k = 5: it reads
// 2 * B * C * D/2 = 800 KiB of candidate rows, the B x D query, the ids,
// the mask and B * C norms, and writes B * (2k + C) int32: under 0.3 us at
// 3.35 TB/s. The C^2 comparisons (80,000 for the batch) are a few
// microseconds of one SM's integer pipes per lane, spread over B blocks.
// Launch latency and the dependent reads of one block bound it. Design:
// one block per lane; each warp reads whole candidate rows in place at
// clamp(id, 0, N - 1) with coalesced 4-byte loads of both planes and
// dp4a's the rebuilt INT8 words against the lane's raw query, split into
// its even and odd words with `__byte_perm` on each pair of query words
// (byte by byte when D/2 % 4 != 0), so no pack runs per call and every D
// is served; it reduces with shuffles; scores, norms, wins and ranks sit
// in dynamic shared memory (16 * C bytes: C up to 14,528); the threads walk
// the C^2 pairs as one strided loop (consecutive threads on consecutive
// candidates, so the counting atomics rarely meet), twice for cosine
// (wins, then ranks) and once for MIPS.

#include "nibble.cuh"

namespace {

constexpr int kThreads = 1024;  // 32 warps: a row per warp for C <= 32
constexpr int32_t kMaskedScore = -2147483647;  // the engine's MASKED_SCORE

enum Metric { kCosine = 0, kMips = 1 };

__device__ __forceinline__ int cos_sign(int32_t s, int32_t n) {
  return n > 0 ? (s > 0) - (s < 0) : 0;
}

__device__ __forceinline__ unsigned long long squared(int32_t s) {
  const long long v = s;
  const unsigned long long a = static_cast<unsigned long long>(v < 0 ? -v : v);
  return a * a;  // |s| <= 2^31, so a * a <= 2^62
}

// s_a / sqrt(n_a) > s_b / sqrt(n_b), the non-division comparator.
__device__ __forceinline__ bool cosine_gt(int32_t sa, int32_t na, int32_t sb,
                                          int32_t nb) {
  const int ga = cos_sign(sa, na);
  const int gb = cos_sign(sb, nb);
  if (ga != gb) return ga > gb;
  if (ga == 0) return false;
  const unsigned long long a2 = squared(sa), b2 = squared(sb);
  const unsigned long long nb1 = nb > 1 ? nb : 1, na1 = na > 1 ? na : 1;
  const unsigned long long hi_a = __umul64hi(a2, nb1), lo_a = a2 * nb1;
  const unsigned long long hi_b = __umul64hi(b2, na1), lo_b = b2 * na1;
  const bool gt = hi_a > hi_b || (hi_a == hi_b && lo_a > lo_b);
  const bool lt = hi_a < hi_b || (hi_a == hi_b && lo_a < lo_b);
  return ga > 0 ? gt : lt;
}

// The even and odd query words of row word w (dims 8w ... 8w + 7) read
// byte by byte from the raw query; dims at or past 2 * D2 read as zero.
__device__ __forceinline__ void query_word_bytes(const int8_t* qrow, int w,
                                                 int D2, uint32_t& ew,
                                                 uint32_t& ow) {
  ew = 0;
  ow = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int j = 4 * w + i;
    if (j < D2) {
      ew |= static_cast<uint32_t>(static_cast<uint8_t>(__ldg(qrow + 2 * j)))
            << (8 * i);
      ow |= static_cast<uint32_t>(
                static_cast<uint8_t>(__ldg(qrow + 2 * j + 1))) << (8 * i);
    }
  }
}

// For every ordered pair (i, j) of the C candidates, adds 1 to count[i]
// where pred(i, j). Thread t takes pairs t, t + T, ... with i = p % C and
// j = p / C, stepped without a division per pair.
template <typename Pred>
__device__ __forceinline__ void count_pairs(int C, int* count, Pred pred) {
  const long long pairs = static_cast<long long>(C) * C;
  int i = threadIdx.x % C;
  int j = threadIdx.x / C;
  const int step_i = kThreads % C, step_j = kThreads / C;
  for (long long p = threadIdx.x; p < pairs; p += kThreads) {
    if (pred(i, j)) atomicAdd(count + i, 1);
    i += step_i;
    j += step_j;
    if (i >= C) {
      i -= C;
      ++j;
    }
  }
}

// One block per lane b. EXACT: scores are the exact INT8 dots of the
// lane's candidates, read by id from the (N, D2) planes with the (B, D)
// raw query, norms gathered from the (N,) norms, non-members (member
// given and 0) pinned to (MASKED_SCORE, 1); out_cand (B, C) gets the ids,
// -1 at non-members. Else scores and norms are the (B, C) inputs. Then
// out_idx (B, k) = ids at the top k positions in rank order and
// out_scores (B, k) their scores (-1 and 0 where the candidate is not a
// member). MODE kWord (D2 % 4 == 0) or kByte.
template <bool EXACT, int MODE, int METRIC>
__global__ void __launch_bounds__(kThreads)
rerank_kernel(const int8_t* __restrict__ q, const uint8_t* __restrict__ msb,
              const uint8_t* __restrict__ lsb,
              const int32_t* __restrict__ ids,
              const uint8_t* __restrict__ member,
              const int32_t* __restrict__ norms,
              const int32_t* __restrict__ scores_in,
              int32_t* __restrict__ out_idx, int32_t* __restrict__ out_scores,
              int32_t* __restrict__ out_cand, int C, int D2, long long N,
              int k) {
  extern __shared__ __align__(16) int smem[];
  int* s_sh = smem;             // [C] scores (pinned)
  int* n_sh = s_sh + C;         // [C] norms (pinned)
  int* wins = n_sh + C;         // [C]
  int* rank = wins + C;         // [C]
  const long long b = blockIdx.x;
  const int32_t* lane_ids = ids + b * C;
  const uint8_t* lane_member = member == nullptr ? nullptr : member + b * C;

  for (int c = threadIdx.x; c < C; c += kThreads) {
    wins[c] = 0;
    rank[c] = 0;
  }
  if constexpr (EXACT) {
    const int words = (D2 + 3) / 4;
    const int8_t* qrow = q + b * 2 * D2;
    const uint2* qw = reinterpret_cast<const uint2*>(qrow);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int c = warp; c < C; c += kThreads / 32) {
      const int32_t id = __ldg(lane_ids + c);
      const long long src = id < 0 ? 0 : (id >= N ? N - 1 : id);
      const uint8_t* mrow = msb + static_cast<size_t>(src) * D2;
      const uint8_t* lrow = lsb + static_cast<size_t>(src) * D2;
      const uint32_t* m = reinterpret_cast<const uint32_t*>(mrow);
      const uint32_t* l = reinterpret_cast<const uint32_t*>(lrow);
      int s = 0;
#pragma unroll 2
      for (int w = lane; w < words; w += 32) {
        uint32_t mw, lw, ew, ow;
        if constexpr (MODE == kByte) {
          mw = byte_word(mrow, w, D2);
          lw = byte_word(lrow, w, D2);
          query_word_bytes(qrow, w, D2, ew, ow);
        } else {
          mw = __ldg(m + w);
          lw = __ldg(l + w);
          // Raw query bytes 8w ... 8w + 7 are dims 8w ... 8w + 7: the even
          // dims are bytes 0, 2, 4, 6 of the pair of words, the odd 1, 3,
          // 5, 7. Every warp of the lane reads the same 8 bytes: L1 hits.
          const uint2 x = __ldg(qw + w);
          ew = __byte_perm(x.x, x.y, 0x6420);
          ow = __byte_perm(x.x, x.y, 0x7531);
        }
        const uint32_t even = ((mw & 0x0F0F0F0Fu) << 4) | (lw & 0x0F0F0F0Fu);
        const uint32_t odd = (mw & 0xF0F0F0F0u) | ((lw >> 4) & 0x0F0F0F0Fu);
        s = __dp4a(static_cast<int>(even), static_cast<int>(ew), s);
        s = __dp4a(static_cast<int>(odd), static_cast<int>(ow), s);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        s += __shfl_down_sync(0xffffffffu, s, o);
      }
      if (lane == 0) {
        const bool in = lane_member == nullptr || lane_member[c] != 0;
        s_sh[c] = in ? s : kMaskedScore;
        if constexpr (METRIC == kCosine) {
          n_sh[c] = in ? __ldg(norms + src) : 1;
        }
        out_cand[b * C + c] = in ? id : -1;
      }
    }
  } else {
    for (int c = threadIdx.x; c < C; c += kThreads) {
      s_sh[c] = __ldg(scores_in + b * C + c);
      if constexpr (METRIC == kCosine) n_sh[c] = __ldg(norms + b * C + c);
    }
  }
  __syncthreads();

  const int* key = s_sh;
  if constexpr (METRIC == kCosine) {
    count_pairs(C, wins, [&](int i, int j) {
      return cosine_gt(s_sh[i], n_sh[i], s_sh[j], n_sh[j]);
    });
    __syncthreads();
    key = wins;
  }
  count_pairs(C, rank, [&](int i, int j) {
    return key[j] > key[i] || (key[j] == key[i] && j < i);
  });
  __syncthreads();

  for (int c = threadIdx.x; c < C; c += kThreads) {
    const int r = rank[c];
    if (r < k) {
      const bool in = lane_member == nullptr || lane_member[c] != 0;
      out_idx[b * k + r] = in ? lane_ids[c] : -1;
      out_scores[b * k + r] = in ? s_sh[c] : 0;
    }
  }
}

template <bool EXACT, int MODE, int METRIC>
cudaError_t launch(int B, int C, int D2, long long N, int k, size_t smem,
                   cudaStream_t s, const int8_t* q, const uint8_t* msb,
                   const uint8_t* lsb, const int32_t* ids,
                   const uint8_t* member, const int32_t* norms,
                   const int32_t* scores_in, int32_t* out_idx,
                   int32_t* out_scores, int32_t* out_cand) {
  auto kernel = rerank_kernel<EXACT, MODE, METRIC>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<B, kThreads, smem, s>>>(q, msb, lsb, ids, member, norms,
                                   scores_in, out_idx, out_scores, out_cand,
                                   C, D2, N, k);
  return cudaGetLastError();
}

// Dynamic shared memory of one block: the four (C,) int32 arrays (the
// wrapper checks the same bytes against the limit).
size_t rerank_smem(int C) { return 16 * static_cast<size_t>(C); }

}  // namespace

// The whole exact stage: q (B, D = 2 * D2) int8 raw queries (8-byte
// aligned rows when D2 % 4 == 0), msb/lsb (N, D2) planes, ids (B, C)
// int32, member (B, C) bool or null, norms (N,) int32, metric 0 cosine or
// 1 MIPS -> out_idx (B, k), out_scores (B, k), out_cand (B, C) int32.
extern "C" int stage2_exact_rerank_launch(
    const void* q, const void* msb, const void* lsb, const void* ids,
    const void* member, const void* norms, void* out_idx, void* out_scores,
    void* out_cand, int B, int C, int D2, long long N, int k, int metric,
    void* stream) {
  const size_t smem = rerank_smem(C);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* q8 = static_cast<const int8_t*>(q);
  const auto* m = static_cast<const uint8_t*>(msb);
  const auto* l = static_cast<const uint8_t*>(lsb);
  const auto* id = static_cast<const int32_t*>(ids);
  const auto* mem = static_cast<const uint8_t*>(member);
  const auto* nrm = static_cast<const int32_t*>(norms);
  auto* oi = static_cast<int32_t*>(out_idx);
  auto* os = static_cast<int32_t*>(out_scores);
  auto* oc = static_cast<int32_t*>(out_cand);
  cudaError_t err;
  if (D2 % 4 == 0) {
    err = metric == kCosine
        ? launch<true, kWord, kCosine>(B, C, D2, N, k, smem, s, q8, m, l, id,
                                       mem, nrm, nullptr, oi, os, oc)
        : launch<true, kWord, kMips>(B, C, D2, N, k, smem, s, q8, m, l, id,
                                     mem, nrm, nullptr, oi, os, oc);
  } else {
    err = metric == kCosine
        ? launch<true, kByte, kCosine>(B, C, D2, N, k, smem, s, q8, m, l, id,
                                       mem, nrm, nullptr, oi, os, oc)
        : launch<true, kByte, kMips>(B, C, D2, N, k, smem, s, q8, m, l, id,
                                     mem, nrm, nullptr, oi, os, oc);
  }
  return static_cast<int>(err);
}

// The ranking half: scores, norms and ids (B, C) int32, metric 0 cosine
// or 1 MIPS -> out_idx (B, k) = ids at the top k, out_scores (B, k).
extern "C" int stage2_rerank_launch(const void* scores, const void* norms,
                                    const void* ids, void* out_idx,
                                    void* out_scores, int B, int C, int k,
                                    int metric, void* stream) {
  const size_t smem = rerank_smem(C);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* sc = static_cast<const int32_t*>(scores);
  const auto* nrm = static_cast<const int32_t*>(norms);
  const auto* id = static_cast<const int32_t*>(ids);
  auto* oi = static_cast<int32_t*>(out_idx);
  auto* os = static_cast<int32_t*>(out_scores);
  const cudaError_t err = metric == kCosine
      ? launch<false, kWord, kCosine>(B, C, 0, 0, k, smem, s, nullptr,
                                      nullptr, nullptr, id, nullptr, nrm, sc,
                                      oi, os, nullptr)
      : launch<false, kWord, kMips>(B, C, 0, 0, k, smem, s, nullptr, nullptr,
                                    nullptr, id, nullptr, nrm, sc, oi, os,
                                    nullptr);
  return static_cast<int>(err);
}
