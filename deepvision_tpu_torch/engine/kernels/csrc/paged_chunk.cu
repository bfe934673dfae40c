// Paged chunk attention for chunked prefill: C chunk queries over the page
// pool.
//
// Replaces deepvision_tpu/engine/kernels/paged_chunk.py::_chunk_kernel
// (reached through paged_chunk_attention's pallas_call).
//
//   q [B, C, H, HD] bf16 (RoPE applied); pools [KV, N, P, HD] bf16 or int8
//   with the chunk's rows already written; block_tables [B, MP];
//   chunk_starts [B]; seq_lens [B] = n, the chunk's end; k_scale/v_scale
//   [KV] f32 (ones for bf16 pools).
//   out[b, c, kv*G+g] = softmax_col(q . k_col * HD^-0.5 * k_scale)
//                       @ v_col * v_scale
//   over columns col <= chunk_starts[b] + c and col < n; a row with no such
//   column is 0.  Rows past n (the padded tail of a last chunk) attend to
//   every column < n, as the TPU kernel's mask says.
//
// Design: the TPU grid (B, KV) with one [C*G, HD] q block would be 2 blocks
// at the main path's shape (B=1, KV=2), on a card with 132 SMs.  Here one
// block takes (64-row tile, kv head, sequence) over the C*G rows of a kv
// head, row r being query r / G of group member r % G, so a K/V column
// staged once serves the whole GQA group; at C=256, G=3 that is 12 tiles x
// 2 kv heads = 24 blocks.  A tile walks columns only up to
// min(n, its last row's position + 1) (the causal skip), 64 columns (32 at
// HD=256) at a time: each column's page comes from the block table (only
// the cdiv(n, P) entries that are live are read); K/V rows are read as
// 16-byte vectors into registers one tile ahead, so their loads overlap the
// current tile's arithmetic, then staged in shared memory as float; an
// online softmax (running max, sum; four lanes per row) keeps the output
// accumulator in registers, 4 rows x HD/16 columns per thread of a 16 x 16
// grid.  For int8 pools the K scale folds into the q
// scale and the V scale into the final normalize.  q and out are indexed in
// their [B, C, H, HD] layout here, so the wrapper transposes nothing.
//
// Bound on this card: at the main path's shape (C=256, H=6, KV=2, HD=128,
// a resume from 768 to n=1024) the work is ~0.71 GFLOP against ~1.8 MB of
// bytes (q and out 0.79 MB, the live K/V rows 1.05 MB): bound by operations
// at the bf16 tensor-core rate (~0.7 us).  The simple design runs fp32 FMA
// on the CUDA cores and fills 24 of 132 SMs; left for later: tensor cores
// (mma.sync / wgmma), splitting the columns over more blocks with a merge
// pass, and cp.async/TMA copies straight into shared memory.

#include "common.cuh"

namespace {

constexpr int BR = 64;    // (query, group member) rows per block
constexpr int NT = 256;   // threads per block (16 x 16)
constexpr int MAXG = 8;   // query heads per kv head this kernel takes

template <int HD>
struct ChunkTile {
  static constexpr int BK = HD >= 256 ? 32 : 64;  // columns per tile
  static constexpr int QS = HD + 1;               // padded row stride
  static constexpr int PS = BK + 1;
  static constexpr int FLOATS = BR * QS + BK * QS + BK * HD + BR * PS + 3 * BR;
  static constexpr int BYTES = FLOATS * 4;
};

// One tile's K and V rows as 16-byte vectors, VEC pool elements each,
// spread over the block's threads and held in registers.
template <typename PT, int HD, int BK>
struct TileRegs {
  static constexpr int VEC = 16 / sizeof(PT);
  static constexpr int VPR = HD / VEC;               // vectors per row
  static constexpr int NV = BK * VPR;                // vectors per tile
  static constexpr int PER = (NV + NT - 1) / NT;      // vectors per thread
  uint4 k[PER], v[PER];

  // Issue the loads of columns [k_start, k_start + BK); columns at or past
  // `limit` read nothing and hold zeros.
  __device__ __forceinline__ void load(const PT* k_pages, const PT* v_pages,
                                       const int* bt, int kv, int N, int P,
                                       int k_start, int limit, int tid) {
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int i = tid + u * NT, c = i / VPR, col = k_start + c;
      k[u] = v[u] = make_uint4(0u, 0u, 0u, 0u);
      if (i < NV && col < limit) {
        const size_t at =
            ((static_cast<size_t>(kv) * N + bt[col / P]) * P + col % P) * HD +
            (i % VPR) * VEC;
        k[u] = *reinterpret_cast<const uint4*>(k_pages + at);
        v[u] = *reinterpret_cast<const uint4*>(v_pages + at);
      }
    }
  }

  // Convert to float into sk [BK][QS] and sv [BK][HD].
  __device__ __forceinline__ void store(float* sk, float* sv, int QS,
                                        int tid) const {
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int i = tid + u * NT, c = i / VPR, d0 = (i % VPR) * VEC;
      if (i >= NV) break;
      const PT* kx = reinterpret_cast<const PT*>(&k[u]);
      const PT* vx = reinterpret_cast<const PT*>(&v[u]);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        sk[c * QS + d0 + e] = dv_to_f32(kx[e]);
        sv[c * HD + d0 + e] = dv_to_f32(vx[e]);
      }
    }
  }
};

template <typename PT, int HD>
__global__ void __launch_bounds__(NT)
paged_chunk_kernel(const __nv_bfloat16* __restrict__ q,
                   const PT* __restrict__ k_pages,
                   const PT* __restrict__ v_pages,
                   const int* __restrict__ block_tables,
                   const int* __restrict__ chunk_starts,
                   const int* __restrict__ seq_lens,
                   const float* __restrict__ k_scale,
                   const float* __restrict__ v_scale,
                   __nv_bfloat16* __restrict__ out, int C, int H, int KV,
                   int N, int P, int MP, float scale) {
  using Tile = ChunkTile<HD>;
  constexpr int BK = Tile::BK, QS = Tile::QS, PS = Tile::PS;
  constexpr int RQ = BR / 16;   // rows per thread
  constexpr int CK = BK / 16;   // score columns per thread
  constexpr int CD = HD / 16;   // output columns per thread

  extern __shared__ float smem[];
  float* sq = smem;                 // [BR][QS]  q * scale * k_scale
  float* sk = sq + BR * QS;         // [BK][QS]
  float* sv = sk + BK * QS;         // [BK][HD]
  float* sp = sv + BK * HD;         // [BR][PS]  scores, then probabilities
  float* s_alpha = sp + BR * PS;    // [BR]
  float* s_l = s_alpha + BR;        // [BR]
  float* s_m = s_l + BR;            // [BR]

  const int G = H / KV;
  const int rows = C * G;
  const int r0 = blockIdx.x * BR;
  const int kv = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int start = chunk_starts[b];
  const int n = seq_lens[b];
  const int* bt = block_tables + static_cast<size_t>(b) * MP;
  const float qs = scale * k_scale[kv];

  for (int i = tid; i < BR * HD; i += NT) {
    const int r = i / HD, d = i % HD, row = r0 + r;
    float x = 0.f;
    if (row < rows) {
      const int c = row / G, g = row % G;
      x = dv_to_f32(q[((static_cast<size_t>(b) * C + c) * H + kv * G + g) *
                          HD + d]) * qs;
    }
    sq[r * QS + d] = x;
  }
  if (tid < BR) {
    s_m[tid] = DV_NEG_INF;
    s_l[tid] = 0.f;
  }

  float acc[RQ][CD];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int j = 0; j < CD; ++j) acc[i][j] = 0.f;

  // causal skip: no row of this tile sees a column past its last row
  const int last_row = min(r0 + BR, rows) - 1;
  const int limit = min(n, start + last_row / G + 1);
  const int n_tiles = limit > 0 ? (limit + BK - 1) / BK : 0;
  // K/V tiles go through registers: tile t + 1's loads are in flight
  // while tile t is computed
  TileRegs<PT, HD, BK> regs;
  if (n_tiles > 0)
    regs.load(k_pages, v_pages, bt, kv, N, P, 0, limit, tid);
  for (int t = 0; t < n_tiles; ++t) {
    const int k_start = t * BK;
    __syncthreads();  // the previous tile's readers are done
    regs.store(sk, sv, QS, tid);
    if (t + 1 < n_tiles)
      regs.load(k_pages, v_pages, bt, kv, N, P, k_start + BK, limit, tid);
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
      const int r = ty + 16 * i;
      const int q_pos = start + (r0 + r) / G;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const int c = tx + 16 * j, col = k_start + c;
        sp[r * PS + c] = (col <= q_pos && col < limit) ? s[i][j] : DV_NEG_INF;
      }
    }
    __syncthreads();

    {  // online-softmax bookkeeping: 4 neighbouring lanes per row
      static_assert(NT == 4 * BR, "four threads per row");
      const int r = tid >> 2, part = tid & 3;
      float* prow = sp + r * PS;
      const float m_prev = s_m[r];
      float mx = m_prev;
      for (int c = part; c < BK; c += 4) mx = fmaxf(mx, prow[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      float sum = 0.f;
      for (int c = part; c < BK; c += 4) {
        const float p = expf(prow[c] - mx);
        prow[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float alpha = expf(m_prev - mx);
        s_l[r] = s_l[r] * alpha + sum;
        s_m[r] = mx;
        s_alpha[r] = alpha;
      }
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

  const float vs = v_scale[kv];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int r = ty + 16 * i, row = r0 + r;
    if (row >= rows) continue;
    float l = s_l[r];
    l = (l == 0.f) ? 1.f : l;  // a row with no valid column stays 0
    const int c = row / G, g = row % G;
    __nv_bfloat16* dst =
        out + ((static_cast<size_t>(b) * C + c) * H + kv * G + g) * HD;
#pragma unroll
    for (int j = 0; j < CD; ++j)
      dst[tx + 16 * j] = __float2bfloat16_rn(acc[i][j] / l * vs);
  }
}

template <typename PT, int HD>
int launch(const void* q, const void* kp, const void* vp, const int* bt,
           const int* starts, const int* lens, const float* ks,
           const float* vs, void* out, int B, int C, int H, int KV, int N,
           int P, int MP, float scale, cudaStream_t stream) {
  auto kernel = paged_chunk_kernel<PT, HD>;
  const int bytes = ChunkTile<HD>::BYTES;
  cudaError_t err = dv_allow_smem(kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = C * (H / KV);
  dim3 grid((rows + BR - 1) / BR, KV, B);
  kernel<<<grid, NT, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const PT*>(kp),
      static_cast<const PT*>(vp), bt, starts, lens, ks, vs,
      static_cast<__nv_bfloat16*>(out), C, H, KV, N, P, MP, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename PT>
int dispatch_hd(const void* q, const void* kp, const void* vp, const int* bt,
                const int* starts, const int* lens, const float* ks,
                const float* vs, void* out, int B, int C, int H, int KV,
                int N, int P, int MP, int HD, float scale, cudaStream_t st) {
  switch (HD) {
    case 32: return launch<PT, 32>(q, kp, vp, bt, starts, lens, ks, vs, out, B, C, H, KV, N, P, MP, scale, st);
    case 64: return launch<PT, 64>(q, kp, vp, bt, starts, lens, ks, vs, out, B, C, H, KV, N, P, MP, scale, st);
    case 128: return launch<PT, 128>(q, kp, vp, bt, starts, lens, ks, vs, out, B, C, H, KV, N, P, MP, scale, st);
    case 256: return launch<PT, 256>(q, kp, vp, bt, starts, lens, ks, vs, out, B, C, H, KV, N, P, MP, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int dv_paged_chunk(const void* q, const void* k_pages,
                              const void* v_pages, const void* block_tables,
                              const void* chunk_starts, const void* seq_lens,
                              const void* k_scale, const void* v_scale,
                              void* out, int B, int C, int H, int KV, int N,
                              int P, int MP, int HD, int q_dtype,
                              int pool_dtype, float scale, void* stream) {
  if (B <= 0 || C <= 0 || KV <= 0 || P <= 0 || MP <= 0 || H % KV != 0 ||
      H / KV > MAXG || q_dtype != DV_BF16)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* bt = static_cast<const int*>(block_tables);
  const int* starts = static_cast<const int*>(chunk_starts);
  const int* lens = static_cast<const int*>(seq_lens);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pool_dtype == DV_BF16)
    return dispatch_hd<__nv_bfloat16>(q, k_pages, v_pages, bt, starts, lens, ks, vs, out, B, C, H, KV, N, P, MP, HD, scale, st);
  if (pool_dtype == DV_I8)
    return dispatch_hd<int8_t>(q, k_pages, v_pages, bt, starts, lens, ks, vs, out, B, C, H, KV, N, P, MP, HD, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
