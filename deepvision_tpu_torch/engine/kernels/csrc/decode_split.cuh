// The column split shared by the paged decode kernels: paged_decode.cu
// (#1, the engine's decode step) and paged_attention.cu (#6 read-only, #7
// with the write).
//
// A decode step has one query row per head, so a grid of one block per
// (kv head, sequence) is B x KV blocks: 16 at the report lane's shape on an
// H100's 132 SMs.  Each kernel therefore launches nsplit blocks per (kv
// head, sequence); block `split` takes one contiguous range of the
// sequence's live columns, whole pages each, computed on the card from
// seq_lens (the host never reads the lengths: the fused K-step decode has
// one host sync, and the split adds none).  Each block keeps an fp32
// online softmax over its range and writes its unnormalised state; a
// second kernel merges the states of a row, as flash decoding does.
//
//   ranges:   pages = cdiv(n, P), per = cdiv(pages, nsplit) pages;
//             split s takes columns [s * per * P, min(n, (s + 1) * per * P))
//             and may be empty (the last splits of a short sequence).
//   the row:  with a write, only the block whose range holds column
//             len - 1 stores the step's K/V row into its page, and it
//             takes that column from new_k / new_v, never from the pool;
//             no block reads column len - 1 from the pool, so the blocks
//             of a launch need no order among them.
//   partials: row r = ((b * KV + kv) * nsplit + split) * G + g holds
//             part_acc[r * HD + d] = sum_c p_c v_c[d] (no v_scale) and
//             part_ml[2 r] = m (natural-log units: the scores are
//             q . k * HD^-0.5 * k_scale, exponentiated with expf),
//             part_ml[2 r + 1] = l = sum_c p_c; an empty range writes
//             m = -inf, l = 0 and no acc (a grid sized for the active
//             slots leaves most of an idle slot's blocks empty).
//   merge:    M = max_s m_s; w_s = exp(m_s - M), and an empty split's acc
//             is never added (w_s 0 selects it out, whatever it holds);
//             out = sum_s w_s acc_s / sum_s w_s l_s * v_scale, with a sum
//             of 0 (no column at all: len 0 in the read-only kernel) taken
//             as 1, so the row is 0.
// With nsplit 1 a kernel normalises and writes its output itself and no
// merge runs.  The wrapper picks nsplit (at most 32) from B, KV, the SM
// count and the block tables' capacity (kernels/paged_attention.py,
// decode_splits).
#pragma once

#include <math.h>

#include "common.cuh"

// Internal linkage: each source that includes this is its own module (no
// relocatable device code), so each gets its own merge kernel.
namespace {

struct DvColRange {
  int c0, c1;  // columns [c0, c1); empty when c0 >= c1
};

__device__ __forceinline__ DvColRange dv_split_cols(int n, int P, int nsplit,
                                                    int split) {
  const int pages = (n + P - 1) / P;
  const int per = (pages + nsplit - 1) / nsplit * P;
  const int c0 = split * per;
  return {c0, min(n, c0 + per)};
}

// Index of the partial row of query head g of split `split`.
__device__ __forceinline__ size_t dv_part_row(int b, int kv, int KV,
                                              int nsplit, int split, int G,
                                              int g) {
  return ((static_cast<size_t>(b) * KV + kv) * nsplit + split) * G + g;
}

// A 16-byte piece of a pool row as floats: 8 bf16 or 16 int8 values.
template <typename PT>
struct Unpack;
template <>
struct Unpack<__nv_bfloat16> {
  __device__ static __forceinline__ void run(const uint4& u, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
  __device__ static __forceinline__ float2 pair(const __nv_bfloat16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
};
template <>
struct Unpack<int8_t> {
  __device__ static __forceinline__ void run(const uint4& u, float* f) {
    const int8_t* b = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
    for (int i = 0; i < 16; ++i) f[i] = static_cast<float>(b[i]);
  }
  __device__ static __forceinline__ float2 pair(const int8_t* p) {
    const char2 c = *reinterpret_cast<const char2*>(p);
    return make_float2(static_cast<float>(c.x), static_cast<float>(c.y));
  }
};

constexpr int DV_MAX_SPLITS = 32;  // a lane of the merge's warp per split

// One warp per (sequence, query head) row, four rows a block.  Lane s
// holds split s's (m, l), so the row's max and sum are warp reductions;
// the splits' acc rows are loaded CH at a time, the first CH before the
// reductions, so a row waits on memory about once.
template <int HD>
__global__ void __launch_bounds__(128)
dv_decode_merge_kernel(const float* __restrict__ part_acc,
                       const float* __restrict__ part_ml,
                       const float* __restrict__ v_scale,
                       __nv_bfloat16* __restrict__ out, int B, int H, int KV,
                       int nsplit) {
  constexpr int PER = HD / 32;           // channels a lane
  constexpr int CH = PER >= 8 ? 8 : 16;  // splits loaded at once
  const int row = blockIdx.x * 4 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= B * H) return;
  const int G = H / KV, b = row / H, h = row % H, kv = h / G, g = h % G;
  const size_t r0 = dv_part_row(b, kv, KV, nsplit, 0, G, g);
  float v[CH][PER];
  auto load = [&](int s0) {
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const float* pa = part_acc +
                        (r0 + static_cast<size_t>(s0 + c) * G) * HD +
                        lane * PER;
#pragma unroll
      for (int e = 0; e < PER; ++e) v[c][e] = s0 + c < nsplit ? pa[e] : 0.f;
    }
  };
  load(0);
  float m = -INFINITY, l = 0.f;
  if (lane < nsplit) {
    const size_t r = r0 + static_cast<size_t>(lane) * G;
    m = part_ml[2 * r];
    l = part_ml[2 * r + 1];
  }
  float mx = m;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  // an empty split (m = -inf) weighs 0; no split at all leaves the row 0
  const float w = m == -INFINITY ? 0.f : expf(m - mx);
  float l_sum = w * l;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    l_sum += __shfl_xor_sync(0xffffffffu, l_sum, o);
  float acc[PER];
#pragma unroll
  for (int e = 0; e < PER; ++e) acc[e] = 0.f;
  for (int s0 = 0; s0 < nsplit; s0 += CH) {
    if (s0 > 0) load(s0);
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const float ws = __shfl_sync(0xffffffffu, w, (s0 + c) & 31);
#pragma unroll
      for (int e = 0; e < PER; ++e)
        acc[e] = ws != 0.f ? fmaf(ws, v[c][e], acc[e]) : acc[e];
    }
  }
  const float lh = l_sum == 0.f ? 1.f : l_sum;
  const float vs = v_scale ? v_scale[kv] : 1.f;
  __nv_bfloat16* dst = out + static_cast<size_t>(row) * HD + lane * PER;
#pragma unroll
  for (int e = 0; e < PER; ++e) dst[e] = __float2bfloat16_rn(acc[e] / lh * vs);
}

// The merge launch after a split kernel (nsplit > 1); part holds part_acc
// then part_ml, B * KV * nsplit * G * (HD + 2) floats.
template <int HD>
inline int dv_launch_decode_merge(const float* part, const float* v_scale,
                                  void* out, int B, int H, int KV, int nsplit,
                                  cudaStream_t stream) {
  const size_t rows = static_cast<size_t>(B) * H * nsplit;
  dv_decode_merge_kernel<HD><<<(B * H + 3) / 4, 128, 0, stream>>>(
      part, part + rows * HD, v_scale, static_cast<__nv_bfloat16*>(out), B,
      H, KV, nsplit);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
