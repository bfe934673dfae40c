// Causal GQA flash attention forward for prefill.
//
// Replaces deepvision_tpu/engine/kernels/flash_attention.py::_flash_kernel
// (reached through _flash_forward's pallas_call).
//
//   q [B, H, S, HD], k/v [B, KV, S, HD] (bf16 or f32), seq_lens [B] int32
//   out[b, h, r] = softmax_c(q[b,h,r] . k[b,h/G,c] * HD^-0.5) @ v[b,h/G,c]
//   over columns c <= r and c < seq_lens[b]; a row with no such column is 0.
//   With a non-null lse [B, H, S] (float32) it also writes each row's
//   logsumexp m + log(l) of the scaled scores (l = 0 counts as 1), which
//   the backward kernels (flash_bwd.cu) read; it replaces the JAX
//   package's separate XLA pass _row_logsumexp.  Serving passes null.
//
// Design: one block per (q tile of 64 rows, head, batch), 256 threads as a
// 16 x 16 grid.  The block stages the scaled q tile in shared memory once,
// then walks k/v tiles only up to min(q_end, seq_len) (causal and ragged
// skip), staging each through shared memory as float, and keeps an online
// softmax (running max m, sum l) per row with the output accumulator in
// registers (4 rows x HD/16 columns per thread).  All arithmetic is fp32
// FMA on the CUDA cores.
//
// Bound on this card: at the prefill shapes (S = 1024..2048, HD = 128) the
// work is compute-bound (4*B*H*S^2*HD/2 flops against 2*B*(H+2KV)*S*HD
// bytes).  The simple design leaves for later: tensor cores (mma.sync or
// wgmma at 989 TFLOP/s instead of fp32 FMA), TMA/cp.async double buffering
// of the k/v tiles, and more than one block per SM.

#include "common.cuh"

namespace {

constexpr int BQ = 64;    // q rows per block
constexpr int NT = 256;   // threads per block (16 x 16)

template <int HD>
struct FlashTile {
  static constexpr int BK = HD >= 256 ? 32 : 64;  // k/v rows per tile
  static constexpr int QS = HD + 1;               // padded row stride
  static constexpr int PS = BK + 1;
  static constexpr int FLOATS = BQ * QS + BK * QS + BK * HD + BQ * PS + 3 * BQ;
  static constexpr int BYTES = FLOATS * 4;
};

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ seq_lens,
                 T* __restrict__ out, float* __restrict__ lse, int H, int KV,
                 int S, float scale) {
  using Tile = FlashTile<HD>;
  constexpr int BK = Tile::BK, QS = Tile::QS, PS = Tile::PS;
  constexpr int RQ = BQ / 16;   // rows per thread
  constexpr int CK = BK / 16;   // score columns per thread
  constexpr int CD = HD / 16;   // output columns per thread

  extern __shared__ float smem[];
  float* sq = smem;                 // [BQ][QS]  q * scale
  float* sk = sq + BQ * QS;         // [BK][QS]
  float* sv = sk + BK * QS;         // [BK][HD]
  float* sp = sv + BK * HD;         // [BQ][PS]  scores, then probabilities
  float* s_alpha = sp + BQ * PS;    // [BQ]
  float* s_l = s_alpha + BQ;        // [BQ]
  float* s_m = s_l + BQ;            // [BQ]

  const int q_start = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int len = min(seq_lens[b], S);
  const size_t q_off = (static_cast<size_t>(b) * H + h) * S * HD;
  const size_t kv_off = (static_cast<size_t>(b) * KV + kvh) * S * HD;

  for (int i = tid; i < BQ * HD; i += NT) {
    const int r = i / HD, d = i % HD, row = q_start + r;
    sq[r * QS + d] =
        row < S ? dv_to_f32(q[q_off + static_cast<size_t>(row) * HD + d]) * scale
                : 0.f;
  }
  if (tid < BQ) {
    s_m[tid] = DV_NEG_INF;
    s_l[tid] = 0.f;
  }

  float acc[RQ][CD];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int j = 0; j < CD; ++j) acc[i][j] = 0.f;

  const int limit = min(min(q_start + BQ, len), S);
  const int n_tiles = limit > 0 ? (limit + BK - 1) / BK : 0;
  for (int t = 0; t < n_tiles; ++t) {
    const int k_start = t * BK;
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < BK * HD; i += NT) {
      const int c = i / HD, d = i % HD, col = k_start + c;
      float kf = 0.f, vf = 0.f;
      if (col < S) {
        const size_t at = kv_off + static_cast<size_t>(col) * HD + d;
        kf = dv_to_f32(k[at]);
        vf = dv_to_f32(v[at]);
      }
      sk[c * QS + d] = kf;
      sv[c * HD + d] = vf;
    }
    __syncthreads();

    float s[RQ][CK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qr[RQ], kc[CK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) qr[i] = sq[(ty + 16 * i) * QS + d];
#pragma unroll
      for (int j = 0; j < CK; ++j) kc[j] = sk[(tx + 16 * j) * QS + d];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CK; ++j) s[i][j] = fmaf(qr[i], kc[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int r = ty + 16 * i, row = q_start + r;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const int c = tx + 16 * j, col = k_start + c;
        sp[r * PS + c] = (col <= row && col < len) ? s[i][j] : DV_NEG_INF;
      }
    }
    __syncthreads();

    if (tid < BQ) {  // one thread per row: online-softmax bookkeeping
      float* prow = sp + tid * PS;
      const float m_prev = s_m[tid];
      float m_new = m_prev;
      for (int c = 0; c < BK; ++c) m_new = fmaxf(m_new, prow[c]);
      float sum = 0.f;
      for (int c = 0; c < BK; ++c) {
        const float p = expf(prow[c] - m_new);
        prow[c] = p;
        sum += p;
      }
      const float alpha = expf(m_prev - m_new);
      s_l[tid] = s_l[tid] * alpha + sum;
      s_m[tid] = m_new;
      s_alpha[tid] = alpha;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const float a = s_alpha[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < CD; ++j) acc[i][j] *= a;
    }
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pr[RQ], vc[CD];
#pragma unroll
      for (int i = 0; i < RQ; ++i) pr[i] = sp[(ty + 16 * i) * PS + c];
#pragma unroll
      for (int j = 0; j < CD; ++j) vc[j] = sv[c * HD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CD; ++j) acc[i][j] = fmaf(pr[i], vc[j], acc[i][j]);
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int r = ty + 16 * i, row = q_start + r;
    if (row >= S) continue;
    float l = s_l[r];
    l = (l == 0.f) ? 1.f : l;  // fully masked rows stay finite (0)
    T* dst = out + q_off + static_cast<size_t>(row) * HD;
#pragma unroll
    for (int j = 0; j < CD; ++j) dst[tx + 16 * j] = dv_from_f32<T>(acc[i][j] / l);
  }
  if (lse != nullptr && tid < BQ && q_start + tid < S) {
    const float l = s_l[tid];
    lse[(static_cast<size_t>(b) * H + h) * S + q_start + tid] =
        s_m[tid] + logf(l == 0.f ? 1.f : l);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const int* seq_lens,
           void* out, float* lse, int B, int H, int KV, int S, float scale,
           cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, HD>;
  const int bytes = FlashTile<HD>::BYTES;
  cudaError_t err = dv_allow_smem(kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((S + BQ - 1) / BQ, H, B);
  kernel<<<grid, NT, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), seq_lens, static_cast<T*>(out), lse, H, KV,
      S, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hd(const void* q, const void* k, const void* v,
                const int* seq_lens, void* out, float* lse, int B, int H,
                int KV, int S, int HD, float scale, cudaStream_t stream) {
  switch (HD) {
    case 32: return launch<T, 32>(q, k, v, seq_lens, out, lse, B, H, KV, S, scale, stream);
    case 64: return launch<T, 64>(q, k, v, seq_lens, out, lse, B, H, KV, S, scale, stream);
    case 128: return launch<T, 128>(q, k, v, seq_lens, out, lse, B, H, KV, S, scale, stream);
    case 256: return launch<T, 256>(q, k, v, seq_lens, out, lse, B, H, KV, S, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int dv_flash_fwd(const void* q, const void* k, const void* v,
                            const void* seq_lens, void* out, void* lse,
                            int B, int H, int KV, int S, int HD, int dtype,
                            float scale, void* stream) {
  if (B <= 0 || S <= 0 || KV <= 0 || H % KV != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* lens = static_cast<const int*>(seq_lens);
  float* row_lse = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DV_BF16)
    return dispatch_hd<__nv_bfloat16>(q, k, v, lens, out, row_lse, B, H, KV, S, HD, scale, st);
  if (dtype == DV_F32)
    return dispatch_hd<float>(q, k, v, lens, out, row_lse, B, H, KV, S, HD, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
