// Fused paged-KV decode step: in-place row write + paged attention.
//
// Replaces deepvision_tpu/engine/kernels/paged_attention.py::_fused_kernel_b
// (reached through paged_attention_update's pallas_call, grid_mode="b").
//
//   q [B, H, HD] bf16; new_k/new_v [B, KV, HD] in the pool dtype (int8
//   rows arrive already quantized); pools [KV, N, P, HD] bf16 or int8;
//   k_scale/v_scale [KV] f32; block_tables [B, MP]; seq_lens [B] counting
//   the current token.
//   1. pools[kv, bt[b, (len-1)/P], (len-1)%P] = new row   (in place)
//   2. out[b, kv*G+g] = softmax_c(q . k_c * HD^-0.5 * k_scale) @ v_c * v_scale
//      over the kv head's G query heads and columns c < len.
//
// Design: one block per (kv head, sequence), 8 warps.  The block first
// writes its own kv head's new row, then a __syncthreads() makes that
// global write visible to the block's own reads (the pools are read with
// plain loads, never the read-only path).  Each warp takes every 8th
// column; the 32 lanes split HD, so a column's K row and V row are each
// read once, coalesced, and the warp keeps an online softmax for all G
// heads at once (a butterfly shuffle sums each head's dot product).  The
// warps' partial (m, l, acc) are merged through shared memory at the end.
// Inactive scheduler slots all point at trash page 0 and race on its row
// 0; their outputs are discarded, as in the TPU kernel.
//
// Bound on this card: HBM bytes.  Each step must read the live K/V rows
// (2 * len * HD * itemsize per kv head and sequence); the math is ~2 flops
// per byte.  The simple design leaves for later: more blocks per sequence
// (split-K over columns, then a merge pass) to fill 132 SMs at small
// batch, vectorised 16-byte loads, and cp.async/TMA prefetch of pages.

#include "common.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int MAXG = 8;  // query heads per kv head this kernel takes

template <typename QT, typename PT, int HD>
__global__ void __launch_bounds__(WARPS * 32)
paged_decode_kernel(const QT* __restrict__ q, const PT* __restrict__ new_k,
                    const PT* __restrict__ new_v, PT* k_pages, PT* v_pages,
                    const int* __restrict__ block_tables,
                    const int* __restrict__ seq_lens,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale, QT* __restrict__ out,
                    int H, int KV, int N, int P, int MP, float scale) {
  constexpr int EPL = HD / 32;  // elements of a row per lane
  __shared__ float sm_acc[WARPS][HD];
  __shared__ float sm_m[WARPS];
  __shared__ float sm_l[WARPS];

  const int kv = blockIdx.x, b = blockIdx.y;
  const int G = H / KV;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = seq_lens[b];
  const int* bt = block_tables + static_cast<size_t>(b) * MP;

  // 1) write this step's row for this kv head
  {
    const int pos = len - 1;
    const int page = bt[pos / P], off = pos % P;
    const size_t dst = ((static_cast<size_t>(kv) * N + page) * P + off) * HD;
    const size_t src = (static_cast<size_t>(b) * KV + kv) * HD;
    for (int d = tid; d < HD; d += WARPS * 32) {
      k_pages[dst + d] = new_k[src + d];
      v_pages[dst + d] = new_v[src + d];
    }
  }
  __syncthreads();

  // 2) attention over columns [0, len)
  const float qs = scale * k_scale[kv];
  float qv[MAXG][EPL], acc[MAXG][EPL], m[MAXG], l[MAXG];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m[g] = DV_NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      acc[g][e] = 0.f;
      qv[g][e] = g < G ? dv_to_f32(q[(static_cast<size_t>(b) * H + kv * G + g) * HD +
                                     lane * EPL + e]) * qs
                       : 0.f;
    }
  }

  for (int c = warp; c < len; c += WARPS) {
    const int page = bt[c / P];
    const size_t row =
        ((static_cast<size_t>(kv) * N + page) * P + c % P) * HD + lane * EPL;
    float kf[EPL], vf[EPL];
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      kf[e] = dv_to_f32(k_pages[row + e]);
      vf[e] = dv_to_f32(v_pages[row + e]);
    }
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g >= G) break;
      float s = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) s = fmaf(qv[g][e], kf[e], s);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      const float m_new = fmaxf(m[g], s);
      const float alpha = expf(m[g] - m_new);
      const float p = expf(s - m_new);
      l[g] = l[g] * alpha + p;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e] * alpha);
      m[g] = m_new;
    }
  }

  // 3) merge the warps' partial softmax states, one head at a time
  const float vs = v_scale[kv];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g >= G) break;  // G is uniform over the block
    if (lane == 0) {
      sm_m[warp] = m[g];
      sm_l[warp] = l[g];
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e) sm_acc[warp][lane * EPL + e] = acc[g][e];
    __syncthreads();
    float mx = DV_NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, sm_m[w]);
    for (int d = tid; d < HD; d += WARPS * 32) {
      float lsum = 0.f, a = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        const float f = expf(sm_m[w] - mx);
        lsum = fmaf(sm_l[w], f, lsum);
        a = fmaf(sm_acc[w][d], f, a);
      }
      lsum = (lsum == 0.f) ? 1.f : lsum;
      out[(static_cast<size_t>(b) * H + kv * G + g) * HD + d] =
          dv_from_f32<QT>(a / lsum * vs);
    }
    __syncthreads();
  }
}

template <typename QT, typename PT, int HD>
int launch(const void* q, const void* nk, const void* nv, void* kp, void* vp,
           const int* bt, const int* lens, const float* ks, const float* vs,
           void* out, int B, int H, int KV, int N, int P, int MP, float scale,
           cudaStream_t stream) {
  dim3 grid(KV, B);
  paged_decode_kernel<QT, PT, HD><<<grid, WARPS * 32, 0, stream>>>(
      static_cast<const QT*>(q), static_cast<const PT*>(nk),
      static_cast<const PT*>(nv), static_cast<PT*>(kp), static_cast<PT*>(vp),
      bt, lens, ks, vs, static_cast<QT*>(out), H, KV, N, P, MP, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename QT, typename PT>
int dispatch_hd(const void* q, const void* nk, const void* nv, void* kp,
                void* vp, const int* bt, const int* lens, const float* ks,
                const float* vs, void* out, int B, int H, int KV, int N, int P,
                int MP, int HD, float scale, cudaStream_t st) {
  switch (HD) {
    case 32: return launch<QT, PT, 32>(q, nk, nv, kp, vp, bt, lens, ks, vs, out, B, H, KV, N, P, MP, scale, st);
    case 64: return launch<QT, PT, 64>(q, nk, nv, kp, vp, bt, lens, ks, vs, out, B, H, KV, N, P, MP, scale, st);
    case 128: return launch<QT, PT, 128>(q, nk, nv, kp, vp, bt, lens, ks, vs, out, B, H, KV, N, P, MP, scale, st);
    case 256: return launch<QT, PT, 256>(q, nk, nv, kp, vp, bt, lens, ks, vs, out, B, H, KV, N, P, MP, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int dv_paged_decode_update(
    const void* q, const void* new_k, const void* new_v, void* k_pages,
    void* v_pages, const void* block_tables, const void* seq_lens,
    const void* k_scale, const void* v_scale, void* out, int B, int H, int KV,
    int N, int P, int MP, int HD, int q_dtype, int pool_dtype, float scale,
    void* stream) {
  if (B <= 0 || KV <= 0 || H % KV != 0 || H / KV > MAXG)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* bt = static_cast<const int*>(block_tables);
  const int* lens = static_cast<const int*>(seq_lens);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == DV_BF16 && pool_dtype == DV_BF16)
    return dispatch_hd<__nv_bfloat16, __nv_bfloat16>(
        q, new_k, new_v, k_pages, v_pages, bt, lens, ks, vs, out, B, H, KV, N, P, MP, HD, scale, st);
  if (q_dtype == DV_BF16 && pool_dtype == DV_I8)
    return dispatch_hd<__nv_bfloat16, int8_t>(
        q, new_k, new_v, k_pages, v_pages, bt, lens, ks, vs, out, B, H, KV, N, P, MP, HD, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
