// Causal GQA flash attention backward: dQ and dK/dV.
//
// Replaces deepvision_tpu/engine/kernels/flash_attention.py::
//   _flash_bwd_dq_kernel  (pallas_call in _flash_backward, dQ)
//   _flash_bwd_dkv_kernel (pallas_call in _flash_backward, dK/dV)
//
//   q, dout [B, H, S, HD]; k, v [B, KV, S, HD] (bf16 or f32, one dtype);
//   lse, delta [B, H, S] float32; seq_lens [B] int32.  With
//     p[r, c]  = exp(q[r] . k[c] * scale - lse[r])  where c <= r, c < len
//     ds[r, c] = p[r, c] * (dout[r] . v[c] - delta[r])
//   dq[r] = scale * sum_c ds[r, c] k[c]                     (every row r)
//   dk[c] = sum_{g, r < len} ds[r, c] q[r] * scale
//   dv[c] = sum_{g, r < len} p[r, c] dout[r]
//   over the G = H / KV query heads g of k's kv head.  lse is the forward's
//   row logsumexp (flash_fwd.cu writes it), delta = rowsum(dout * out).
//   As in the JAX kernels, dQ does not mask rows past seq_len (their
//   gradient is computed like any row's) and dK/dV does: a cotangent on a
//   padded row never reaches K or V.  A row with no valid column (len 0)
//   gets p = 0 from the mask, never from an exp that underflows.
//
// Design (FlashAttention-2's split; no atomics, so gradients are
// deterministic):
// - dQ: one block per (q tile of 64 rows, head, batch).  The scaled q tile
//   and the dout tile are staged in shared memory once; the block walks
//   k/v tiles only up to min(q_end, seq_len) and keeps the dq tile in
//   registers.  The grid's x index runs the q tiles backwards, so the
//   tiles with the most k/v tiles to walk start first.
// - dK/dV: one block per (k tile, kv head, batch).  The k and v tiles stay
//   in shared memory; the block loops over the GQA group's G query heads
//   inside (no K/V duplication) and, for each, over the q tiles from the
//   one holding k_start to cdiv(seq_len, BQ), keeping dk and dv in
//   registers.
// - 256 threads as a 16 x 16 grid; tiles are staged as float with 16-byte
//   global loads; all arithmetic is fp32 FMA on the CUDA cores; outputs
//   are written in the input dtype.
// - Shared memory: at HD = 256 the tiles shrink to 32 rows on the k side
//   (dQ, 206 KB) and on both sides (dK/dV, 140 KB), under the 227 KB a
//   block may take.
//
// The JAX package switches to the dense VJP when one kv head's query group
// ([G, S, HD] of q and dout) exceeds 8 MiB: that limit is the TPU's VMEM,
// where its dK/dV kernel holds the whole group.  These kernels stream
// q/dout tiles and take every shape, so the port has no such switch.
//
// Bound on this card: at the training shape (B=8, H=6, KV=2, S=2048,
// HD=128, bf16) dQ does 3 and dK/dV 4 matmuls over the causal half,
// 77 and 103 GFLOP, against ~25 MB per q-shaped tensor: compute-bound
// (0.078 / 0.104 ms at the bf16 tensor-core rate).  Left for later:
// tensor cores (mma.sync / wgmma), TMA or cp.async double buffering, and
// more than one block per SM.

#include "common.cuh"

namespace {

constexpr int NT = 256;  // threads per block (16 x 16)

template <int HD>
struct DqTile {
  static constexpr int BQ = 64;                   // q rows per block
  static constexpr int BK = HD >= 256 ? 32 : 64;  // k/v rows per tile
  static constexpr int QS = HD + 1;               // padded row stride
  static constexpr int PS = BK + 1;
  static constexpr int FLOATS = 2 * BQ * QS + 2 * BK * QS + BQ * PS + 2 * BQ;
  static constexpr int BYTES = FLOATS * 4;
};

template <int HD>
struct DkvTile {
  static constexpr int BK = HD >= 256 ? 32 : 64;  // k/v rows per block
  static constexpr int BQ = HD >= 256 ? 32 : 64;  // q rows per step
  static constexpr int QS = HD + 1;
  static constexpr int PS = BK + 1;
  static constexpr int FLOATS = 2 * BK * QS + 2 * BQ * QS + 2 * BQ * PS + 2 * BQ;
  static constexpr int BYTES = FLOATS * 4;
};

// 16 bytes of T unpacked to floats.
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void unpack(const float* src, float* f) {
    const float4 x = *reinterpret_cast<const float4*>(src);
    f[0] = x.x; f[1] = x.y; f[2] = x.z; f[3] = x.w;
  }
};
template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void unpack(const __nv_bfloat16* src,
                                                float* f) {
    const uint4 x = *reinterpret_cast<const uint4*>(src);
    const __nv_bfloat162* pairs = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 g = __bfloat1622float2(pairs[i]);
      f[2 * i] = g.x;
      f[2 * i + 1] = g.y;
    }
  }
};

// Stage ROWS rows of HD values (contiguous from src) into dst with row
// stride STRIDE, times mul; rows at or past `valid` are 0.
template <typename T, int HD, int ROWS, int STRIDE>
__device__ __forceinline__ void stage_rows(float* dst, const T* src, int valid,
                                           float mul, int tid) {
  constexpr int VEC = Vec16<T>::N;
  constexpr int PER_ROW = HD / VEC;
  for (int i = tid; i < ROWS * PER_ROW; i += NT) {
    const int r = i / PER_ROW, d0 = (i % PER_ROW) * VEC;
    float f[VEC];
    if (r < valid) {
      Vec16<T>::unpack(src + static_cast<size_t>(r) * HD + d0, f);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) f[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) dst[r * STRIDE + d0 + e] = f[e] * mul;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const int* __restrict__ seq_lens, T* __restrict__ dq,
                    int H, int KV, int S, float scale) {
  using Tile = DqTile<HD>;
  constexpr int BQ = Tile::BQ, BK = Tile::BK, QS = Tile::QS, PS = Tile::PS;
  constexpr int RQ = BQ / 16;  // rows per thread
  constexpr int CK = BK / 16;  // score columns per thread
  constexpr int CD = HD / 16;  // dq columns per thread

  extern __shared__ float smem[];
  float* sq = smem;              // [BQ][QS]  q * scale
  float* sdo = sq + BQ * QS;     // [BQ][QS]
  float* sk = sdo + BQ * QS;     // [BK][QS]
  float* sv = sk + BK * QS;      // [BK][QS]
  float* sds = sv + BK * QS;     // [BQ][PS]
  float* s_lse = sds + BQ * PS;  // [BQ]
  float* s_d = s_lse + BQ;       // [BQ]

  const int q_start = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int len = min(seq_lens[b], S);
  const size_t row_off = (static_cast<size_t>(b) * H + h) * S;
  const size_t q_off = row_off * HD;
  const size_t kv_off = (static_cast<size_t>(b) * KV + kvh) * S * HD;

  stage_rows<T, HD, BQ, QS>(sq, q + q_off + static_cast<size_t>(q_start) * HD,
                            S - q_start, scale, tid);
  stage_rows<T, HD, BQ, QS>(sdo,
                            dout + q_off + static_cast<size_t>(q_start) * HD,
                            S - q_start, 1.f, tid);
  if (tid < BQ) {
    const int row = q_start + tid;
    s_lse[tid] = row < S ? lse[row_off + row] : 0.f;
    s_d[tid] = row < S ? delta[row_off + row] : 0.f;
  }

  float acc[RQ][CD];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int j = 0; j < CD; ++j) acc[i][j] = 0.f;

  const int limit = min(q_start + BQ, len);
  const int n_tiles = limit > 0 ? (limit + BK - 1) / BK : 0;
  for (int t = 0; t < n_tiles; ++t) {
    const int k_start = t * BK;
    __syncthreads();  // the previous tile's readers are done
    stage_rows<T, HD, BK, QS>(sk, k + kv_off + static_cast<size_t>(k_start) * HD,
                              S - k_start, 1.f, tid);
    stage_rows<T, HD, BK, QS>(sv, v + kv_off + static_cast<size_t>(k_start) * HD,
                              S - k_start, 1.f, tid);
    __syncthreads();

    float s[RQ][CK], dp[RQ][CK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qr[RQ], dr[RQ], kc[CK], vc[CK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        qr[i] = sq[(ty + 16 * i) * QS + d];
        dr[i] = sdo[(ty + 16 * i) * QS + d];
      }
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        kc[j] = sk[(tx + 16 * j) * QS + d];
        vc[j] = sv[(tx + 16 * j) * QS + d];
      }
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CK; ++j) {
          s[i][j] = fmaf(qr[i], kc[j], s[i][j]);
          dp[i][j] = fmaf(dr[i], vc[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int r = ty + 16 * i, row = q_start + r;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const int c = tx + 16 * j, col = k_start + c;
        const float p =
            (col <= row && col < len) ? expf(s[i][j] - s_lse[r]) : 0.f;
        sds[r * PS + c] = p * (dp[i][j] - s_d[r]);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float dsr[RQ], kc[CD];
#pragma unroll
      for (int i = 0; i < RQ; ++i) dsr[i] = sds[(ty + 16 * i) * PS + c];
#pragma unroll
      for (int j = 0; j < CD; ++j) kc[j] = sk[c * QS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CD; ++j) acc[i][j] = fmaf(dsr[i], kc[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int row = q_start + ty + 16 * i;
    if (row >= S) continue;
    T* dst = dq + q_off + static_cast<size_t>(row) * HD;
#pragma unroll
    for (int j = 0; j < CD; ++j)
      dst[tx + 16 * j] = dv_from_f32<T>(acc[i][j] * scale);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const int* __restrict__ seq_lens, T* __restrict__ dk,
                     T* __restrict__ dv, int H, int KV, int S, float scale) {
  using Tile = DkvTile<HD>;
  constexpr int BQ = Tile::BQ, BK = Tile::BK, QS = Tile::QS, PS = Tile::PS;
  constexpr int RQ = BQ / 16;  // score rows per thread
  constexpr int CK = BK / 16;  // score columns per thread
  constexpr int RK = BK / 16;  // dk/dv rows per thread
  constexpr int CD = HD / 16;  // dk/dv columns per thread

  extern __shared__ float smem[];
  float* sk = smem;              // [BK][QS]
  float* sv = sk + BK * QS;      // [BK][QS]
  float* sq = sv + BK * QS;      // [BQ][QS]  q * scale
  float* sdo = sq + BQ * QS;     // [BQ][QS]
  float* sp = sdo + BQ * QS;     // [BQ][PS]  p
  float* sds = sp + BQ * PS;     // [BQ][PS]  ds
  float* s_lse = sds + BQ * PS;  // [BQ]
  float* s_d = s_lse + BQ;       // [BQ]

  const int k_start = blockIdx.x * BK;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int len = min(seq_lens[b], S);
  const size_t kv_off = (static_cast<size_t>(b) * KV + kvh) * S * HD +
                        static_cast<size_t>(k_start) * HD;

  stage_rows<T, HD, BK, QS>(sk, k + kv_off, S - k_start, 1.f, tid);
  stage_rows<T, HD, BK, QS>(sv, v + kv_off, S - k_start, 1.f, tid);

  float acc_k[RK][CD], acc_v[RK][CD];
#pragma unroll
  for (int i = 0; i < RK; ++i)
#pragma unroll
    for (int j = 0; j < CD; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  // q tiles from the one holding k_start (causal) to the last valid row
  const int qt0 = k_start / BQ;
  const int qt1 = k_start < len ? (len + BQ - 1) / BQ : qt0;
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const size_t row_off = (static_cast<size_t>(b) * H + h) * S;
    for (int qt = qt0; qt < qt1; ++qt) {
      const int q_start = qt * BQ;
      __syncthreads();  // the previous tile's readers are done
      const size_t at = (row_off + q_start) * HD;
      stage_rows<T, HD, BQ, QS>(sq, q + at, S - q_start, scale, tid);
      stage_rows<T, HD, BQ, QS>(sdo, dout + at, S - q_start, 1.f, tid);
      if (tid < BQ) {
        const int row = q_start + tid;
        s_lse[tid] = row < S ? lse[row_off + row] : 0.f;
        s_d[tid] = row < S ? delta[row_off + row] : 0.f;
      }
      __syncthreads();

      float s[RQ][CK], dp[RQ][CK];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CK; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < HD; ++d) {
        float qr[RQ], dr[RQ], kc[CK], vc[CK];
#pragma unroll
        for (int i = 0; i < RQ; ++i) {
          qr[i] = sq[(ty + 16 * i) * QS + d];
          dr[i] = sdo[(ty + 16 * i) * QS + d];
        }
#pragma unroll
        for (int j = 0; j < CK; ++j) {
          kc[j] = sk[(tx + 16 * j) * QS + d];
          vc[j] = sv[(tx + 16 * j) * QS + d];
        }
#pragma unroll
        for (int i = 0; i < RQ; ++i)
#pragma unroll
          for (int j = 0; j < CK; ++j) {
            s[i][j] = fmaf(qr[i], kc[j], s[i][j]);
            dp[i][j] = fmaf(dr[i], vc[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const int r = ty + 16 * i, row = q_start + r;
#pragma unroll
        for (int j = 0; j < CK; ++j) {
          const int c = tx + 16 * j, col = k_start + c;
          const bool live = col <= row && col < len && row < len;
          const float p = live ? expf(s[i][j] - s_lse[r]) : 0.f;
          sp[r * PS + c] = p;
          sds[r * PS + c] = p * (dp[i][j] - s_d[r]);
        }
      }
      __syncthreads();

#pragma unroll 4
      for (int r = 0; r < BQ; ++r) {
        float pr[RK], dsr[RK], qd[CD], dd[CD];
#pragma unroll
        for (int i = 0; i < RK; ++i) {
          pr[i] = sp[r * PS + ty + 16 * i];
          dsr[i] = sds[r * PS + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < CD; ++j) {
          qd[j] = sq[r * QS + tx + 16 * j];
          dd[j] = sdo[r * QS + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < RK; ++i)
#pragma unroll
          for (int j = 0; j < CD; ++j) {
            acc_v[i][j] = fmaf(pr[i], dd[j], acc_v[i][j]);
            acc_k[i][j] = fmaf(dsr[i], qd[j], acc_k[i][j]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const int col = k_start + ty + 16 * i;
    if (col >= S) continue;
    const size_t at = kv_off + static_cast<size_t>(ty + 16 * i) * HD;
#pragma unroll
    for (int j = 0; j < CD; ++j) {
      dk[at + tx + 16 * j] = dv_from_f32<T>(acc_k[i][j]);
      dv[at + tx + 16 * j] = dv_from_f32<T>(acc_v[i][j]);
    }
  }
}

struct BwdArgs {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  const int* seq_lens;
  void *dq, *dk, *dv;
  int B, H, KV, S;
  float scale;
  cudaStream_t stream;
};

template <typename T, int HD>
int launch_dq(const BwdArgs& a) {
  auto kernel = flash_bwd_dq_kernel<T, HD>;
  const int bytes = DqTile<HD>::BYTES;
  cudaError_t err = dv_allow_smem(kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((a.S + DqTile<HD>::BQ - 1) / DqTile<HD>::BQ, a.H, a.B);
  kernel<<<grid, NT, bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, a.seq_lens, static_cast<T*>(a.dq), a.H, a.KV, a.S, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch_dkv(const BwdArgs& a) {
  auto kernel = flash_bwd_dkv_kernel<T, HD>;
  const int bytes = DkvTile<HD>::BYTES;
  cudaError_t err = dv_allow_smem(kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((a.S + DkvTile<HD>::BK - 1) / DkvTile<HD>::BK, a.KV, a.B);
  kernel<<<grid, NT, bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, a.seq_lens, static_cast<T*>(a.dk), static_cast<T*>(a.dv),
      a.H, a.KV, a.S, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool DQ>
int dispatch_hd(const BwdArgs& a, int HD) {
  switch (HD) {
    case 32: return DQ ? launch_dq<T, 32>(a) : launch_dkv<T, 32>(a);
    case 64: return DQ ? launch_dq<T, 64>(a) : launch_dkv<T, 64>(a);
    case 128: return DQ ? launch_dq<T, 128>(a) : launch_dkv<T, 128>(a);
    case 256: return DQ ? launch_dq<T, 256>(a) : launch_dkv<T, 256>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool DQ>
int dispatch(const BwdArgs& a, int HD, int dtype) {
  if (a.B <= 0 || a.S <= 0 || a.KV <= 0 || a.H % a.KV != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == DV_BF16) return dispatch_hd<__nv_bfloat16, DQ>(a, HD);
  if (dtype == DV_F32) return dispatch_hd<float, DQ>(a, HD);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int dv_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, const void* seq_lens,
                               void* dq, int B, int H, int KV, int S, int HD,
                               int dtype, float scale, void* stream) {
  BwdArgs a{q, k, v, dout, static_cast<const float*>(lse),
            static_cast<const float*>(delta),
            static_cast<const int*>(seq_lens), dq, nullptr, nullptr,
            B, H, KV, S, scale, static_cast<cudaStream_t>(stream)};
  return dispatch<true>(a, HD, dtype);
}

extern "C" int dv_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, const void* seq_lens,
                                void* dk, void* dv, int B, int H, int KV,
                                int S, int HD, int dtype, float scale,
                                void* stream) {
  BwdArgs a{q, k, v, dout, static_cast<const float*>(lse),
            static_cast<const float*>(delta),
            static_cast<const int*>(seq_lens), nullptr, dk, dv,
            B, H, KV, S, scale, static_cast<cudaStream_t>(stream)};
  return dispatch<false>(a, HD, dtype);
}
