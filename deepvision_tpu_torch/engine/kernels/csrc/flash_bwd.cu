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
// Both dtypes keep FlashAttention-2's split (no atomics, so gradients are
// deterministic): dQ runs one block per (q tile, head, batch) and walks the
// k/v tiles up to min(q_end, seq_len), its grid's x index running the q
// tiles backwards so the heaviest start first; dK/dV runs one block per
// (k tile, kv head, batch) and loops over the GQA group's G query heads
// inside (no K/V duplication) and, for each, over the q tiles from the one
// holding k_start to cdiv(seq_len, BQ).  Two routes, chosen by dtype alone
// (no path leads from one to the other):
//
// bf16 -- the tensor-core kernels (flash_bwd_dq_tc_kernel,
// flash_bwd_dkv_tc_kernel), the training path:
// - Every product runs on the tensor cores as mma.sync.m16n8k16 (bf16 x
//   bf16 -> fp32): S = q.k^T, dP = dO.v^T, dQ = dS.k in dQ; S^T = k.q^T,
//   dP^T = v.dO^T, dV = P^T.dO, dK = dS^T.q in dK/dV.  Operands come from
//   shared memory through ldmatrix (ldmatrix.trans for the operands read
//   along their rows: k in dQ, q and dO in dK/dV).  wgmma is not used yet:
//   it is the next step (ROADMAP).
// - The softmax scale is applied in fp32 after q.k (and to dQ and dK at
//   write-out), as the plain version scales q in fp32; q is staged as it
//   is.  p and dS stay fp32 for the masks and the delta subtraction and
//   are rounded to bf16 only where they become the A operand of the second
//   products: the accumulator fragment of S/dP is the A fragment of
//   m16n8k16, so P and dS never leave registers.
// - Tiles are staged in shared memory as bf16 (no conversion), each row's
//   16-byte chunks XOR-swizzled by the row (chunk ^ (row & 7); at HD 32,
//   4 chunks a row, chunk ^ ((row >> 1) & 3)), so the 8 rows an ldmatrix
//   reads fall in 8 different bank groups.
// - The streamed tiles (k/v in dQ; q/dO and lse/delta in dK/dV) go through
//   a two-stage ring of cp.async copies (16 bytes a thread; rows past S
//   zero-filled): the next tile's copy is in flight while the current
//   tile's products run.
// - Masks are applied only on tiles that cross the diagonal or the end of
//   the sequence; a tile wholly inside skips them.
// - dQ: 64 q rows a block, 4 warps of 16 rows; k/v tiles of 64 rows (32
//   at HD 256).  Shared memory: q and dO once, k and v two stages each,
//   lse/delta: 24.5 / 48.5 / 96.5 / 128.5 KB at HD 32 / 64 / 128 / 256, so
//   two blocks (8 warps) fit on an SM up to HD 128.  The dq tile (16 x HD
//   a warp) stays in registers.
// - dK/dV: 64 k rows a block, 4 warps of 16 rows (at HD 256 32 k rows,
//   two warps a row group, each holding half of the head dim's dK/dV
//   accumulators and recomputing S^T/dP^T); q/dO tiles of 32 rows.
//   Shared memory: k and v once, q and dO two stages each, lse/delta two
//   stages: 16.5 / 32.5 / 64.5 / 96.5 KB, two blocks an SM.  dK and dV
//   (16 x HD each a warp, or 16 x HD/2) stay in registers.
//
// f32 -- the CUDA-core kernels (flash_bwd_dq_f32_kernel,
// flash_bwd_dkv_f32_kernel), kept as v1 wrote them: tiles staged as float
// with a +1 row pad, 256 threads as a 16 x 16 grid, fp32 FMA, synchronous
// copies.  TF32 tensor cores would change results the float32 reference
// holds to 1e-4; float32 is not the training path (Trainer runs bf16
// activations).  At HD 256 the tiles shrink to 32 rows on the k side (dQ,
// 206 KB) and on both sides (dK/dV, 140 KB).
//
// The JAX package switches to the dense VJP when one kv head's query group
// ([G, S, HD] of q and dout) exceeds 8 MiB: that limit is the TPU's VMEM,
// where its dK/dV kernel holds the whole group.  These kernels stream
// q/dout tiles and take every shape, so the port has no such switch.
//
// Bound on this card: at the training shape (B=8, H=6, KV=2, S=2048,
// HD=128, bf16) dQ does 3 and dK/dV 4 matmuls over the causal half,
// 77 and 103 GFLOP, against ~25 MB per q-shaped tensor: compute-bound
// (0.078 / 0.104 ms at the bf16 tensor-core rate of 989 TFLOP/s).  v1 ran
// these in fp32 FMA at 18-21 TFLOP/s with float tiles (149 / 166 KB, one
// block an SM) and synchronous copies; this design moves the products to
// the tensor cores, halves the staged bytes and overlaps the copies.

#include "tensor_core.cuh"

namespace {

// ---------------------------------------------------------------------------
// bf16: tensor-core kernels
// ---------------------------------------------------------------------------

template <int HD>
struct TcDq {
  static constexpr int BQ = 64;                   // q rows a block
  static constexpr int BK = HD >= 256 ? 32 : 64;  // k/v rows a tile
  static constexpr int NT = 128;                  // 4 warps x 16 q rows
  static constexpr int MIN_BLOCKS = HD >= 256 ? 1 : 2;
  static constexpr int TQ = BQ * HD, TK = BK * HD;  // tile elements
  static constexpr int BYTES = (2 * TQ + 4 * TK) * 2 + 2 * BQ * 4;
};

template <int HD>
__global__ void __launch_bounds__(TcDq<HD>::NT, TcDq<HD>::MIN_BLOCKS)
flash_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v,
                       const bf16* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       const int* __restrict__ seq_lens, bf16* __restrict__ dq,
                       int H, int KV, int S, float scale) {
  using C = TcDq<HD>;
  constexpr int BQ = C::BQ, BK = C::BK, NT = C::NT;
  constexpr int NS = BK / 8;  // score n-tiles a warp
  constexpr int ND = HD / 8;  // dq n-tiles a warp

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);  // [BQ][HD]
  bf16* sdo = sq + C::TQ;                    // [BQ][HD]
  bf16* sk = sdo + C::TQ;                    // [2][BK][HD]
  bf16* sv = sk + 2 * C::TK;                 // [2][BK][HD]
  float* s_lse = reinterpret_cast<float*>(sv + 2 * C::TK);  // [BQ]
  float* s_d = s_lse + BQ;                                   // [BQ]
  const uint32_t aq = smem_u32(sq), ado = smem_u32(sdo);
  const uint32_t ak = smem_u32(sk), av = smem_u32(sv);

  const int q_start = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
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

  const int limit = min(q_start + BQ, len);
  const int n_tiles = limit > 0 ? (limit + BK - 1) / BK : 0;
  if (n_tiles > 0) {
    load_tile<HD, BQ, NT>(aq, q + q_off + static_cast<size_t>(q_start) * HD,
                          S - q_start, tid);
    load_tile<HD, BQ, NT>(ado,
                          dout + q_off + static_cast<size_t>(q_start) * HD,
                          S - q_start, tid);
    if (tid < BQ) {
      const bool ok = q_start + tid < S;
      const size_t at = ok ? row_off + q_start + tid : row_off;
      cp_async4(smem_u32(s_lse + tid), lse + at, ok);
      cp_async4(smem_u32(s_d + tid), delta + at, ok);
    }
    load_tile<HD, BK, NT>(ak, kb, S, tid);
    load_tile<HD, BK, NT>(av, vb, S, tid);
    cp_commit();
  }

  const int r0 = warp * 16 + (lane >> 2);  // this thread's rows r0, r0 + 8
  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {  // the next k/v tile, into the other stage
      const int nxt = (t + 1) * BK, st = (t + 1) & 1;
      load_tile<HD, BK, NT>(ak + st * C::TK * 2,
                            kb + static_cast<size_t>(nxt) * HD, S - nxt, tid);
      load_tile<HD, BK, NT>(av + st * C::TK * 2,
                            vb + static_cast<size_t>(nxt) * HD, S - nxt, tid);
    }
    cp_commit();
    cp_wait_one();
    __syncthreads();
    const uint32_t kt = ak + (t & 1) * C::TK * 2;
    const uint32_t vt = av + (t & 1) * C::TK * 2;
    const int k_start = t * BK;

    // S = q . k^T and dP = dO . v^T for this warp's 16 rows
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t fq[4], fd[4];
      const int ar = warp * 16 + (lane & 15), ac = kk * 2 + (lane >> 4);
      ldsm_x4(tile_addr<HD>(aq, ar, ac), fq);
      ldsm_x4(tile_addr<HD>(ado, ar, ac), fd);
#pragma unroll
      for (int j = 0; j < NS; j += 2) {
        const int mat = lane >> 3;
        const int br = j * 8 + (mat >> 1) * 8 + (lane & 7);
        const int bc = kk * 2 + (mat & 1);
        uint32_t fk[4], fv[4];
        ldsm_x4(tile_addr<HD>(kt, br, bc), fk);
        ldsm_x4(tile_addr<HD>(vt, br, bc), fv);
        mma(s[j], fq, fk[0], fk[1]);
        mma(s[j + 1], fq, fk[2], fk[3]);
        mma(dp[j], fd, fv[0], fv[1]);
        mma(dp[j + 1], fd, fv[2], fv[3]);
      }
    }

    // dS = p * (dP - delta), rounded to bf16 as dQ's A operand
    const bool masked = k_start + BK - 1 > q_start || k_start + BK > len;
    const float lse2[2] = {s_lse[r0] * LOG2E, s_lse[r0 + 8] * LOG2E};
    const float dl[2] = {s_d[r0], s_d[r0 + 8]};
    uint32_t fds[BK / 16][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(s[j][e] * scale_log2 - lse2[e >> 1]);
        if (masked) {
          const int row = q_start + r0 + (e >> 1) * 8;
          const int col = k_start + j * 8 + 2 * (lane & 3) + (e & 1);
          if (!(col <= row && col < len)) p = 0.f;
        }
        ds[e] = p * (dp[j][e] - dl[e >> 1]);
      }
      fds[j / 2][(j & 1) * 2] = pack_bf16(ds[0], ds[1]);
      fds[j / 2][(j & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }

    // dQ += dS . k
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
#pragma unroll
      for (int j = 0; j < ND; j += 2) {
        const int mat = lane >> 3;
        uint32_t fk[4];
        ldsm_x4_t(tile_addr<HD>(kt, kc * 16 + (mat & 1) * 8 + (lane & 7),
                                j + (mat >> 1)),
                  fk);
        mma(acc[j], fds[kc], fk[0], fk[1]);
        mma(acc[j + 1], fds[kc], fk[2], fk[3]);
      }
    }
    __syncthreads();  // this stage's readers are done before it refills
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q_start + r0 + half * 8;
    if (row >= S) continue;
    bf16* dst = dq + q_off + static_cast<size_t>(row) * HD + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < ND; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + j * 8) = __floats2bfloat162_rn(
          acc[j][2 * half] * scale, acc[j][2 * half + 1] * scale);
  }
}

template <int HD>
struct TcDkv {
  static constexpr int BK = HD >= 256 ? 32 : 64;  // k/v rows a block
  static constexpr int BQ = 32;                   // q rows a streamed tile
  static constexpr int DSPLIT = HD >= 256 ? 2 : 1;  // warps a row group
  static constexpr int NT = (BK / 16) * DSPLIT * 32;  // 128
  static constexpr int MIN_BLOCKS = 2;
  static constexpr int TK = BK * HD, TQ = BQ * HD;
  static constexpr int BYTES = (2 * TK + 4 * TQ) * 2 + 4 * BQ * 4;
};

template <int HD>
__global__ void __launch_bounds__(TcDkv<HD>::NT, TcDkv<HD>::MIN_BLOCKS)
flash_bwd_dkv_tc_kernel(const bf16* __restrict__ q,
                        const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const int* __restrict__ seq_lens,
                        bf16* __restrict__ dk, bf16* __restrict__ dv, int H,
                        int KV, int S, float scale) {
  using C = TcDkv<HD>;
  constexpr int BK = C::BK, BQ = C::BQ, NT = C::NT;
  constexpr int NS = BQ / 8;                // score n-tiles a warp
  constexpr int NDW = HD / C::DSPLIT / 8;   // dk/dv n-tiles a warp

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sk = reinterpret_cast<bf16*>(smem);  // [BK][HD]
  bf16* sv = sk + C::TK;                     // [BK][HD]
  bf16* sq = sv + C::TK;                     // [2][BQ][HD]
  bf16* sdo = sq + 2 * C::TQ;                // [2][BQ][HD]
  float* s_lse = reinterpret_cast<float*>(sdo + 2 * C::TQ);  // [2][BQ]
  float* s_d = s_lse + 2 * BQ;                               // [2][BQ]
  const uint32_t ak = smem_u32(sk), av = smem_u32(sv);
  const uint32_t aq = smem_u32(sq), ado = smem_u32(sdo);

  const int k_start = blockIdx.x * BK;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rg = warp % (BK / 16);        // this warp's 16 k rows
  const int d0 = (warp / (BK / 16)) * NDW;  // its first dk/dv n-tile
  const int len = min(seq_lens[b], S);
  const size_t kv_off = (static_cast<size_t>(b) * KV + kvh) * S * HD +
                        static_cast<size_t>(k_start) * HD;
  const float scale_log2 = scale * LOG2E;

  float acc_k[NDW][4], acc_v[NDW][4];
#pragma unroll
  for (int j = 0; j < NDW; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[j][e] = acc_v[j][e] = 0.f;

  // q tiles from the one holding k_start (causal) to the last valid row,
  // for each of the group's G heads: one flat loop of n_iter steps
  const int qt0 = k_start / BQ;
  const int nq = k_start < len ? (len + BQ - 1) / BQ - qt0 : 0;
  const int n_iter = G * nq;

  auto prefetch = [&](int i) {  // step i's q/dO tile and lse/delta
    const int st = i & 1, q_start = (qt0 + i % nq) * BQ;
    const size_t row_off =
        (static_cast<size_t>(b) * H + kvh * G + i / nq) * S;
    const size_t at = (row_off + q_start) * HD;
    load_tile<HD, BQ, NT>(aq + st * C::TQ * 2, q + at, S - q_start, tid);
    load_tile<HD, BQ, NT>(ado + st * C::TQ * 2, dout + at, S - q_start, tid);
    if (tid < BQ) {
      const bool ok = q_start + tid < S;
      const size_t r = ok ? row_off + q_start + tid : row_off;
      cp_async4(smem_u32(s_lse + st * BQ + tid), lse + r, ok);
      cp_async4(smem_u32(s_d + st * BQ + tid), delta + r, ok);
    }
  };

  if (n_iter > 0) {
    load_tile<HD, BK, NT>(ak, k + kv_off, S - k_start, tid);
    load_tile<HD, BK, NT>(av, v + kv_off, S - k_start, tid);
    prefetch(0);
    cp_commit();
  }

  for (int i = 0; i < n_iter; ++i) {
    if (i + 1 < n_iter) prefetch(i + 1);
    cp_commit();
    cp_wait_one();
    __syncthreads();
    const int st = i & 1, q_start = (qt0 + i % nq) * BQ;
    const uint32_t qt = aq + st * C::TQ * 2, dot = ado + st * C::TQ * 2;
    const float* lse_t = s_lse + st * BQ;
    const float* d_t = s_d + st * BQ;

    // S^T = k . q^T and dP^T = v . dO^T for this warp's 16 k rows
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t fk[4], fv[4];
      const int ar = rg * 16 + (lane & 15), ac = kk * 2 + (lane >> 4);
      ldsm_x4(tile_addr<HD>(ak, ar, ac), fk);
      ldsm_x4(tile_addr<HD>(av, ar, ac), fv);
#pragma unroll
      for (int j = 0; j < NS; j += 2) {
        const int mat = lane >> 3;
        const int br = j * 8 + (mat >> 1) * 8 + (lane & 7);
        const int bc = kk * 2 + (mat & 1);
        uint32_t fq[4], fd[4];
        ldsm_x4(tile_addr<HD>(qt, br, bc), fq);
        ldsm_x4(tile_addr<HD>(dot, br, bc), fd);
        mma(s[j], fk, fq[0], fq[1]);
        mma(s[j + 1], fk, fq[2], fq[3]);
        mma(dp[j], fv, fd[0], fd[1]);
        mma(dp[j + 1], fv, fd[2], fd[3]);
      }
    }

    // P^T and dS^T, rounded to bf16 as the A operands of dV and dK
    const bool masked = k_start + BK - 1 > q_start || q_start + BQ > len;
    uint32_t fp[BQ / 16][4], fds[BQ / 16][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = j * 8 + 2 * (lane & 3) + (e & 1);
        p[e] = exp2f(s[j][e] * scale_log2 - lse_t[ql] * LOG2E);
        if (masked) {
          const int row = q_start + ql;
          const int col = k_start + rg * 16 + (lane >> 2) + (e >> 1) * 8;
          if (!(col <= row && col < len && row < len)) p[e] = 0.f;
        }
        ds[e] = p[e] * (dp[j][e] - d_t[ql]);
      }
      fp[j / 2][(j & 1) * 2] = pack_bf16(p[0], p[1]);
      fp[j / 2][(j & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
      fds[j / 2][(j & 1) * 2] = pack_bf16(ds[0], ds[1]);
      fds[j / 2][(j & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }

    // dV += P^T . dO and dK += dS^T . q over this warp's head-dim columns
#pragma unroll
    for (int kc = 0; kc < BQ / 16; ++kc) {
#pragma unroll
      for (int j = 0; j < NDW; j += 2) {
        const int mat = lane >> 3;
        const int br = kc * 16 + (mat & 1) * 8 + (lane & 7);
        const int bc = d0 + j + (mat >> 1);
        uint32_t fd[4], fq[4];
        ldsm_x4_t(tile_addr<HD>(dot, br, bc), fd);
        ldsm_x4_t(tile_addr<HD>(qt, br, bc), fq);
        mma(acc_v[j], fp[kc], fd[0], fd[1]);
        mma(acc_v[j + 1], fp[kc], fd[2], fd[3]);
        mma(acc_k[j], fds[kc], fq[0], fq[1]);
        mma(acc_k[j + 1], fds[kc], fq[2], fq[3]);
      }
    }
    __syncthreads();  // this stage's readers are done before it refills
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = rg * 16 + (lane >> 2) + half * 8;
    if (k_start + r >= S) continue;
    const size_t at =
        kv_off + static_cast<size_t>(r) * HD + d0 * 8 + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < NDW; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dk + at + j * 8) =
          __floats2bfloat162_rn(acc_k[j][2 * half] * scale,
                                acc_k[j][2 * half + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + at + j * 8) =
          __floats2bfloat162_rn(acc_v[j][2 * half], acc_v[j][2 * half + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA-core kernels
// ---------------------------------------------------------------------------

constexpr int NT32 = 256;  // threads a block (16 x 16)

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

// Stage ROWS rows of HD floats (contiguous from src) into dst with row
// stride STRIDE, times mul; rows at or past `valid` are 0.
template <int HD, int ROWS, int STRIDE>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           int valid, float mul, int tid) {
  constexpr int PER_ROW = HD / 4;
  for (int i = tid; i < ROWS * PER_ROW; i += NT32) {
    const int r = i / PER_ROW, d0 = (i % PER_ROW) * 4;
    float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < valid)
      f = *reinterpret_cast<const float4*>(src + static_cast<size_t>(r) * HD +
                                           d0);
    float* row = dst + r * STRIDE + d0;
    row[0] = f.x * mul;
    row[1] = f.y * mul;
    row[2] = f.z * mul;
    row[3] = f.w * mul;
  }
}

template <int HD>
__global__ void __launch_bounds__(NT32)
flash_bwd_dq_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const int* __restrict__ seq_lens,
                        float* __restrict__ dq, int H, int KV, int S,
                        float scale) {
  using Tile = DqTile<HD>;
  constexpr int BQ = Tile::BQ, BK = Tile::BK, QS = Tile::QS, PS = Tile::PS;
  constexpr int RQ = BQ / 16;  // rows per thread
  constexpr int CK = BK / 16;  // score columns per thread
  constexpr int CD = HD / 16;  // dq columns per thread

  extern __shared__ float smem32[];
  float* sq = smem32;            // [BQ][QS]  q * scale
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

  stage_rows<HD, BQ, QS>(sq, q + q_off + static_cast<size_t>(q_start) * HD,
                         S - q_start, scale, tid);
  stage_rows<HD, BQ, QS>(sdo, dout + q_off + static_cast<size_t>(q_start) * HD,
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
    stage_rows<HD, BK, QS>(sk, k + kv_off + static_cast<size_t>(k_start) * HD,
                           S - k_start, 1.f, tid);
    stage_rows<HD, BK, QS>(sv, v + kv_off + static_cast<size_t>(k_start) * HD,
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
    float* dst = dq + q_off + static_cast<size_t>(row) * HD;
#pragma unroll
    for (int j = 0; j < CD; ++j) dst[tx + 16 * j] = acc[i][j] * scale;
  }
}

template <int HD>
__global__ void __launch_bounds__(NT32)
flash_bwd_dkv_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const int* __restrict__ seq_lens,
                         float* __restrict__ dk, float* __restrict__ dv, int H,
                         int KV, int S, float scale) {
  using Tile = DkvTile<HD>;
  constexpr int BQ = Tile::BQ, BK = Tile::BK, QS = Tile::QS, PS = Tile::PS;
  constexpr int RQ = BQ / 16;  // score rows per thread
  constexpr int CK = BK / 16;  // score columns per thread
  constexpr int RK = BK / 16;  // dk/dv rows per thread
  constexpr int CD = HD / 16;  // dk/dv columns per thread

  extern __shared__ float smem32[];
  float* sk = smem32;            // [BK][QS]
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

  stage_rows<HD, BK, QS>(sk, k + kv_off, S - k_start, 1.f, tid);
  stage_rows<HD, BK, QS>(sv, v + kv_off, S - k_start, 1.f, tid);

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
      stage_rows<HD, BQ, QS>(sq, q + at, S - q_start, scale, tid);
      stage_rows<HD, BQ, QS>(sdo, dout + at, S - q_start, 1.f, tid);
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
      dk[at + tx + 16 * j] = acc_k[i][j];
      dv[at + tx + 16 * j] = acc_v[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

struct BwdArgs {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  const int* seq_lens;
  void *dq, *dk, *dv;
  int B, H, KV, S;
  float scale;
  cudaStream_t stream;
};

template <typename T>
const T* in(const void* p) { return static_cast<const T*>(p); }
template <typename T>
T* out(void* p) { return static_cast<T*>(p); }

template <int HD>
int launch_dq_tc(const BwdArgs& a) {
  using C = TcDq<HD>;
  auto kernel = flash_bwd_dq_tc_kernel<HD>;
  cudaError_t err = dv_allow_smem(kernel, C::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((a.S + C::BQ - 1) / C::BQ, a.H, a.B);
  kernel<<<grid, C::NT, C::BYTES, a.stream>>>(
      in<bf16>(a.q), in<bf16>(a.k), in<bf16>(a.v), in<bf16>(a.dout), a.lse,
      a.delta, a.seq_lens, out<bf16>(a.dq), a.H, a.KV, a.S, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_dkv_tc(const BwdArgs& a) {
  using C = TcDkv<HD>;
  auto kernel = flash_bwd_dkv_tc_kernel<HD>;
  cudaError_t err = dv_allow_smem(kernel, C::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((a.S + C::BK - 1) / C::BK, a.KV, a.B);
  kernel<<<grid, C::NT, C::BYTES, a.stream>>>(
      in<bf16>(a.q), in<bf16>(a.k), in<bf16>(a.v), in<bf16>(a.dout), a.lse,
      a.delta, a.seq_lens, out<bf16>(a.dk), out<bf16>(a.dv), a.H, a.KV, a.S,
      a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_dq_f32(const BwdArgs& a) {
  auto kernel = flash_bwd_dq_f32_kernel<HD>;
  const int bytes = DqTile<HD>::BYTES;
  cudaError_t err = dv_allow_smem(kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((a.S + DqTile<HD>::BQ - 1) / DqTile<HD>::BQ, a.H, a.B);
  kernel<<<grid, NT32, bytes, a.stream>>>(
      in<float>(a.q), in<float>(a.k), in<float>(a.v), in<float>(a.dout),
      a.lse, a.delta, a.seq_lens, out<float>(a.dq), a.H, a.KV, a.S, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_dkv_f32(const BwdArgs& a) {
  auto kernel = flash_bwd_dkv_f32_kernel<HD>;
  const int bytes = DkvTile<HD>::BYTES;
  cudaError_t err = dv_allow_smem(kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((a.S + DkvTile<HD>::BK - 1) / DkvTile<HD>::BK, a.KV, a.B);
  kernel<<<grid, NT32, bytes, a.stream>>>(
      in<float>(a.q), in<float>(a.k), in<float>(a.v), in<float>(a.dout),
      a.lse, a.delta, a.seq_lens, out<float>(a.dk), out<float>(a.dv), a.H,
      a.KV, a.S, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_hd(const BwdArgs& a, bool dq, int dtype) {
  if (dtype == DV_BF16) return dq ? launch_dq_tc<HD>(a) : launch_dkv_tc<HD>(a);
  if (dtype == DV_F32) return dq ? launch_dq_f32<HD>(a) : launch_dkv_f32<HD>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}

int dispatch(const BwdArgs& a, bool dq, int HD, int dtype) {
  if (a.B <= 0 || a.S <= 0 || a.KV <= 0 || a.H % a.KV != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (HD) {
    case 32: return launch_hd<32>(a, dq, dtype);
    case 64: return launch_hd<64>(a, dq, dtype);
    case 128: return launch_hd<128>(a, dq, dtype);
    case 256: return launch_hd<256>(a, dq, dtype);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int HD>
int info_hd(bool dq, int dtype, int* out) {
  if (dtype == DV_BF16)
    return dq ? dv_kernel_info(flash_bwd_dq_tc_kernel<HD>, TcDq<HD>::NT,
                               TcDq<HD>::BYTES, out)
              : dv_kernel_info(flash_bwd_dkv_tc_kernel<HD>, TcDkv<HD>::NT,
                               TcDkv<HD>::BYTES, out);
  if (dtype == DV_F32)
    return dq ? dv_kernel_info(flash_bwd_dq_f32_kernel<HD>, NT32,
                               DqTile<HD>::BYTES, out)
              : dv_kernel_info(flash_bwd_dkv_f32_kernel<HD>, NT32,
                               DkvTile<HD>::BYTES, out);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int dv_flash_bwd_info(int dq, int HD, int dtype, int* out) {
  switch (HD) {
    case 32: return info_hd<32>(dq != 0, dtype, out);
    case 64: return info_hd<64>(dq != 0, dtype, out);
    case 128: return info_hd<128>(dq != 0, dtype, out);
    case 256: return info_hd<256>(dq != 0, dtype, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int dv_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, const void* seq_lens,
                               void* dq, int B, int H, int KV, int S, int HD,
                               int dtype, float scale, void* stream) {
  BwdArgs a{q, k, v, dout, static_cast<const float*>(lse),
            static_cast<const float*>(delta),
            static_cast<const int*>(seq_lens), dq, nullptr, nullptr,
            B, H, KV, S, scale, static_cast<cudaStream_t>(stream)};
  return dispatch(a, true, HD, dtype);
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
  return dispatch(a, false, HD, dtype);
}
