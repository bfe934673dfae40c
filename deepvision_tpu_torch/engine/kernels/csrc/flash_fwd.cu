// Causal GQA flash attention forward for prefill and training.
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
// Bound on this card: at the prefill shape (B=4, H=6, KV=2, S=1024,
// HD=128, lengths 1024/901/640/300) the causal pairs need 5.39 GFLOP
// against 7.3 MB of q, k, v and out; at the training shape (B=8, S=2048,
// full lengths) 51.6 GFLOP against 50 MB: bound by operations, 0.0055 and
// 0.052 ms at the bf16 tensor-core rate of 989 TFLOP/s.
//
// Two routes, chosen by dtype alone (no path leads from one to the other):
//
// bf16 -- flash_fwd_tc_kernel, the serving and training path:
// - One block per (head, sequence, q tile of 64 rows), 4 warps of 16 rows;
//   the grid's z index runs the q tiles backwards, so the heaviest tiles
//   (most columns under the causal mask) start first on every head.
// - Both products run on the tensor cores as mma.sync.m16n8k16 (bf16 x
//   bf16 -> fp32): S = q . k^T with k's B fragments from ldmatrix, and
//   O += P . V with V's from ldmatrix.trans.  Up to HD 128 q's A fragments
//   are read from shared memory once and stay in registers for the whole
//   k loop; at HD 256 they are re-read each tile (registers).
// - The scale is applied in fp32 after q . k, with log2(e) folded in for
//   exp2f: p = exp2(s * scale * log2e - m * scale * log2e), m the running
//   row max of the raw scores.  flash_bwd.cu recomputes p the same way from
//   the lse written here, so the two agree.
// - The online softmax works on the accumulator fragments: a row's running
//   max is reduced over the quad of four lanes that holds it; each lane
//   keeps its part of the running sum in fp32 and the quad adds them up
//   once, at the end.  P is packed to bf16 in registers straight from the
//   S fragments as the A operand of P . V (the only new rounding against
//   the fp32 plain version besides the bf16 operands of q . k).
// - Tiles are staged as bf16 in shared memory with no conversion, each
//   row's 16-byte chunks XOR-swizzled by the row (tensor_core.cuh).  The
//   K/V tiles (64 rows; 32 at HD 256) go through a two-stage cp.async
//   ring: the next tile's copy is in flight while the current one's
//   products run; rows past S are zero-filled (src-size 0).
// - Masks run only on tiles that cross the diagonal or seq_len.  A row of
//   length 0 never enters the loop: its output is 0 and its lse -1e30 +
//   log 1, as v1 wrote it.
// - Shared memory a block: q once, K and V two stages each:
//   20 / 40 / 80 / 96 KB at HD 32 / 64 / 128 / 256.  As an H100 reports
//   them (CUDA 12.8; chip_smoke.py phase `build`, flash_fwd_kernel_info):
//   114 / 158 / 238 / 243 registers a thread, no local memory, 4 / 3 / 2 /
//   2 blocks an SM.  On that card: 0.031 ms at the prefill shape (174
//   TFLOP/s), 0.206 ms at the training shape (251 TFLOP/s); v1 took 0.32
//   and 2.9 ms.
//
// f32 -- flash_fwd_f32_kernel, v1 unchanged: 256 threads as a 16 x 16
// grid, q (times the scale), k and v staged as float, fp32 FMA on the CUDA
// cores, synchronous copies.  TF32 tensor cores would change results the
// float32 reference holds to 1e-4; float32 is not a served or trained path.
//
// Left for later: wgmma (warpgroup tiles with B read straight from
// swizzled shared memory, so that warps stop re-reading K/V through
// ldmatrix), TMA copies completing on mbarriers in place of cp.async, warp
// specialisation (a producer warp for the copies, consumers for the
// products), and packing a GQA group's heads into one block's rows so that
// a staged K/V tile serves all G heads.

#include "tensor_core.cuh"

namespace {

// ---------------------------------------------------------------------------
// bf16: tensor-core kernel
// ---------------------------------------------------------------------------

template <int HD>
struct TcFwd {
  static constexpr int BQ = 64;                   // q rows a block
  static constexpr int BK = HD >= 256 ? 32 : 64;  // k/v rows a tile
  static constexpr int NT = 128;                  // 4 warps x 16 q rows
  static constexpr int MIN_BLOCKS = 2;
  static constexpr bool Q_REGS = HD <= 128;       // q fragments in registers
  static constexpr int TQ = BQ * HD, TK = BK * HD;  // tile elements
  static constexpr int BYTES = (TQ + 4 * TK) * 2;
};

template <int HD>
__global__ void __launch_bounds__(TcFwd<HD>::NT, TcFwd<HD>::MIN_BLOCKS)
flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v,
                    const int* __restrict__ seq_lens, bf16* __restrict__ out,
                    float* __restrict__ lse, int H, int KV, int S,
                    float scale) {
  using C = TcFwd<HD>;
  constexpr int NS = C::BK / 8;  // score n-tiles a warp
  constexpr int ND = HD / 8;     // output n-tiles a warp
  constexpr int KQ = HD / 16;    // k steps of q . k^T

  extern __shared__ __align__(128) unsigned char smem_tc[];
  bf16* sq = reinterpret_cast<bf16*>(smem_tc);  // [BQ][HD]
  bf16* sk = sq + C::TQ;                     // [2][BK][HD]
  bf16* sv = sk + 2 * C::TK;                 // [2][BK][HD]
  const uint32_t aq = smem_u32(sq), ak = smem_u32(sk), av = smem_u32(sv);

  const int q_start = (gridDim.z - 1 - blockIdx.z) * C::BQ;
  const int h = blockIdx.x, b = blockIdx.y;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int len = min(seq_lens[b], S);
  const size_t row_off = (static_cast<size_t>(b) * H + h) * S;
  const size_t q_off = row_off * HD;
  const bf16* kb = k + (static_cast<size_t>(b) * KV + kvh) * S * HD;
  const bf16* vb = v + (static_cast<size_t>(b) * KV + kvh) * S * HD;
  const float scale_log2 = scale * LOG2E;

  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  // rows r0 and r0 + 8 of this thread: running max of the raw scores and
  // this lane's part of the running sum
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  const int limit = min(q_start + C::BQ, len);
  const int n_tiles = limit > 0 ? (limit + C::BK - 1) / C::BK : 0;
  if (n_tiles > 0) {
    load_tile<HD, C::BQ, C::NT>(
        aq, q + q_off + static_cast<size_t>(q_start) * HD, S - q_start, tid);
    load_tile<HD, C::BK, C::NT>(ak, kb, S, tid);
    load_tile<HD, C::BK, C::NT>(av, vb, S, tid);
    cp_commit();
  }

  const int r0 = warp * 16 + (lane >> 2);
  uint32_t fq[C::Q_REGS ? KQ : 1][4];
  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {  // the next k/v tile, into the other stage
      const int nxt = (t + 1) * C::BK, st = (t + 1) & 1;
      load_tile<HD, C::BK, C::NT>(ak + st * C::TK * 2,
                                  kb + static_cast<size_t>(nxt) * HD,
                                  S - nxt, tid);
      load_tile<HD, C::BK, C::NT>(av + st * C::TK * 2,
                                  vb + static_cast<size_t>(nxt) * HD,
                                  S - nxt, tid);
    }
    cp_commit();
    cp_wait_one();
    __syncthreads();
    const uint32_t kt = ak + (t & 1) * C::TK * 2;
    const uint32_t vt = av + (t & 1) * C::TK * 2;
    const int k_start = t * C::BK;
    const int ar = warp * 16 + (lane & 15);
    if constexpr (C::Q_REGS) {
      if (t == 0) {
#pragma unroll
        for (int kk = 0; kk < KQ; ++kk)
          ldsm_x4(tile_addr<HD>(aq, ar, kk * 2 + (lane >> 4)), fq[kk]);
      }
    }

    // S = q . k^T for this warp's 16 rows (raw, unscaled)
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk) {
      uint32_t fa[4];
      if constexpr (C::Q_REGS) {
#pragma unroll
        for (int e = 0; e < 4; ++e) fa[e] = fq[kk][e];
      } else {
        ldsm_x4(tile_addr<HD>(aq, ar, kk * 2 + (lane >> 4)), fa);
      }
#pragma unroll
      for (int j = 0; j < NS; j += 2) {
        const int mat = lane >> 3;
        const int br = j * 8 + (mat >> 1) * 8 + (lane & 7);
        const int bc = kk * 2 + (mat & 1);
        uint32_t fk[4];
        ldsm_x4(tile_addr<HD>(kt, br, bc), fk);
        mma(s[j], fa, fk[0], fk[1]);
        mma(s[j + 1], fa, fk[2], fk[3]);
      }
    }

    // causal and length masks, on edge tiles only
    if (k_start + C::BK - 1 > q_start || k_start + C::BK > len) {
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = q_start + r0 + (e >> 1) * 8;
          const int col = k_start + j * 8 + 2 * (lane & 3) + (e & 1);
          if (!(col <= row && col < len)) s[j][e] = -INFINITY;
        }
    }

    // online softmax: the rows' new max over the quad, the rescale of the
    // running sum and accumulator, then P in bf16 as P . V's A operand
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
    float mb[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      // every row has a valid column (column 0) in the first tile, so mx
      // is finite from there on; the guard keeps -inf - -inf out anyway
      mb[i] = mx[i] == -INFINITY ? 0.f : mx[i] * scale_log2;
      const float alpha = exp2f(m[i] * scale_log2 - mb[i]);
      m[i] = mx[i];
      l[i] *= alpha;
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        acc[j][2 * i] *= alpha;
        acc[j][2 * i + 1] *= alpha;
      }
    }
    uint32_t fp[C::BK / 16][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p[e] = exp2f(fmaf(s[j][e], scale_log2, -mb[e >> 1]));
      l[0] += p[0] + p[1];
      l[1] += p[2] + p[3];
      fp[j / 2][(j & 1) * 2] = pack_bf16(p[0], p[1]);
      fp[j / 2][(j & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
    }

    // O += P . V
#pragma unroll
    for (int kc = 0; kc < C::BK / 16; ++kc) {
#pragma unroll
      for (int j = 0; j < ND; j += 2) {
        const int mat = lane >> 3;
        uint32_t fv[4];
        ldsm_x4_t(tile_addr<HD>(vt, kc * 16 + (mat & 1) * 8 + (lane & 7),
                                j + (mat >> 1)),
                  fv);
        mma(acc[j], fp[kc], fv[0], fv[1]);
        mma(acc[j + 1], fp[kc], fv[2], fv[3]);
      }
    }
    __syncthreads();  // this stage's readers are done before it refills
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q_start + r0 + half * 8;
    if (row >= S) continue;
    const float lh = l[half] == 0.f ? 1.f : l[half];  // len 0: output 0
    bf16* dst = out + q_off + static_cast<size_t>(row) * HD + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < ND; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + j * 8) = __floats2bfloat162_rn(
          acc[j][2 * half] / lh, acc[j][2 * half + 1] / lh);
    if (lse != nullptr && (lane & 3) == 0)
      lse[row_off + row] =  // length 0: -1e30 + log 1, as v1 wrote it
          l[half] == 0.f ? DV_NEG_INF : m[half] * scale + logf(l[half]);
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA-core kernel (v1)
// ---------------------------------------------------------------------------

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
flash_fwd_f32_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v,
                     const int* __restrict__ seq_lens, T* __restrict__ out,
                     float* __restrict__ lse, int H, int KV, int S,
                     float scale) {
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

template <int HD>
int launch_tc(const void* q, const void* k, const void* v,
              const int* seq_lens, void* out, float* lse, int B, int H,
              int KV, int S, float scale, cudaStream_t stream) {
  using C = TcFwd<HD>;
  auto kernel = flash_fwd_tc_kernel<HD>;
  cudaError_t err = dv_allow_smem(kernel, C::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(H, B, (S + C::BQ - 1) / C::BQ);
  kernel<<<grid, C::NT, C::BYTES, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), seq_lens, static_cast<bf16*>(out), lse, H,
      KV, S, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v,
               const int* seq_lens, void* out, float* lse, int B, int H,
               int KV, int S, float scale, cudaStream_t stream) {
  auto kernel = flash_fwd_f32_kernel<float, HD>;
  const int bytes = FlashTile<HD>::BYTES;
  cudaError_t err = dv_allow_smem(kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((S + BQ - 1) / BQ, H, B);
  kernel<<<grid, NT, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), seq_lens, static_cast<float*>(out), lse,
      H, KV, S, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_hd(const void* q, const void* k, const void* v,
              const int* seq_lens, void* out, float* lse, int B, int H,
              int KV, int S, int dtype, float scale, cudaStream_t stream) {
  if (dtype == DV_BF16)
    return launch_tc<HD>(q, k, v, seq_lens, out, lse, B, H, KV, S, scale,
                         stream);
  if (dtype == DV_F32)
    return launch_f32<HD>(q, k, v, seq_lens, out, lse, B, H, KV, S, scale,
                          stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int HD>
int info_hd(int dtype, int* out) {
  if (dtype == DV_BF16)
    return dv_kernel_info(flash_fwd_tc_kernel<HD>, TcFwd<HD>::NT,
                          TcFwd<HD>::BYTES, out);
  if (dtype == DV_F32)
    return dv_kernel_info(flash_fwd_f32_kernel<float, HD>, NT,
                          FlashTile<HD>::BYTES, out);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int dv_flash_fwd_info(int HD, int dtype, int* out) {
  switch (HD) {
    case 32: return info_hd<32>(dtype, out);
    case 64: return info_hd<64>(dtype, out);
    case 128: return info_hd<128>(dtype, out);
    case 256: return info_hd<256>(dtype, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int dv_flash_fwd(const void* q, const void* k, const void* v,
                            const void* seq_lens, void* out, void* lse,
                            int B, int H, int KV, int S, int HD, int dtype,
                            float scale, void* stream) {
  if (B <= 0 || S <= 0 || KV <= 0 || H % KV != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* lens = static_cast<const int*>(seq_lens);
  float* row_lse = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (HD) {
    case 32: return launch_hd<32>(q, k, v, lens, out, row_lse, B, H, KV, S, dtype, scale, st);
    case 64: return launch_hd<64>(q, k, v, lens, out, row_lse, B, H, KV, S, dtype, scale, st);
    case 128: return launch_hd<128>(q, k, v, lens, out, row_lse, B, H, KV, S, dtype, scale, st);
    case 256: return launch_hd<256>(q, k, v, lens, out, row_lse, B, H, KV, S, dtype, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
