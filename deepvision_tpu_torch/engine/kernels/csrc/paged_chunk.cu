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
// Bound on this card: at the main path's shape (B=1, C=256, H=6, KV=2,
// HD=128, a prefix resume from 640 to n=896) the causal pairs need
// 0.60 GFLOP against 1.7 MB (q and out 0.79 MB, the live K/V rows
// 0.92 MB): bound by operations, 0.61 us at the bf16 tensor-core rate.
//
// Design (one kernel for bf16 and int8 pools, on the tensor cores):
// - The rows stay packed as the TPU kernel packs them: row r of a kv head
//   is query r / G of group member r % G, at position chunk_starts + r / G,
//   so a K/V tile staged once serves the whole GQA group.  One block per
//   (64-row tile, kv head, sequence), 4 warps of 16 rows: at the main shape
//   12 tiles x 2 kv heads = 24 blocks.  A tile walks columns only up to
//   min(n, its last row's position + 1) (the causal skip), 64 at a time
//   (32 at HD 256).  q and out are read and written in their [B, C, H, HD]
//   layout (a row's HD values are contiguous), so the wrapper transposes
//   nothing.
// - A tile gathers its K/V columns through the block table, reading only
//   the cdiv(n, P) live entries (at P = 64 one page is one tile, at P = 16
//   a tile spans four pages).  bf16 pools: cp.async 16 bytes at a time
//   straight into the swizzled bf16 tile, through a two-stage ring.  int8
//   pools: 16-byte int8 vectors are loaded into registers one tile ahead
//   (at HD 256, where the accumulators take 128 registers a thread, in the
//   same step: ahead they spilled), converted to bf16 (exact for
//   |x| <= 127) and stored to the swizzled tile of the other stage.
// - S = q . k^T and O += P . V run as mma.sync.m16n8k16 (bf16 x bf16 ->
//   fp32) from ldmatrix fragments (V through ldmatrix.trans); q's A
//   fragments stay in registers up to HD 128.  k_scale goes onto the fp32
//   scores together with HD^-0.5 (and log2 e, for exp2f) after the mma,
//   not into a bf16 q; v_scale at the final normalize, as the TPU kernel
//   applies them.  The online softmax runs on the accumulator fragments
//   (row max over the lane quad), and P is packed to bf16 in registers as
//   P . V's A operand.  Masks run only on tiles that cross a row's
//   position or n.
// - The column split.  At the main shape the grid above is 24 blocks of 4
//   warps on 132 SMs, and a block walks ~14 tiles one after the other:
//   on an H100 the kernel took 0.036 ms of device time there, behind
//   SDPA on gathered K/V (0.031 ms); split 8 ways, 0.015 ms (v1: 0.19
//   ms).  So the wrapper splits each tile's columns over `nsplit` blocks
//   (chosen from the grid: up to 8, so that the blocks fill the SMs twice
//   over); each walks its share of whole tiles and writes its
//   unnormalised (m, l, acc) in fp32 to scratch the wrapper allocates, and
//   paged_chunk_merge_kernel (one warp a row) merges the shares and writes
//   the bf16 output.  With nsplit 1 (a grid of row tiles that fills the
//   card) the block writes its output itself and nothing is merged.
// - Shared memory a block: q once, K and V two stages each:
//   20 / 40 / 80 / 96 KB at HD 32 / 64 / 128 / 256.  As an H100 reports
//   them (CUDA 12.8; chip_smoke.py phase `build`,
//   paged_chunk_kernel_info): 124 / 166 / 254 / 255 registers a thread for
//   bf16 pools, 128 / 174 / 255 / 253 for int8, no local memory, 4 / 3 / 2
//   / 2 blocks an SM (int8 at HD 64: 2).
//
// Left for later: wgmma, TMA gathers completing on mbarriers, and warp
// specialisation; a merge folded into the last split's block.

#include "tensor_core.cuh"

namespace {

constexpr int MAXG = 8;  // query heads per kv head this kernel takes

template <int HD>
struct TcChunk {
  static constexpr int BR = 64;                   // rows a block
  static constexpr int BK = HD >= 256 ? 32 : 64;  // columns a tile
  static constexpr int NT = 128;                  // 4 warps x 16 rows
  static constexpr int MIN_BLOCKS = 2;
  static constexpr bool Q_REGS = HD <= 128;       // q fragments in registers
  // int8 tiles loaded a tile ahead; at HD 256, where the accumulators take
  // 128 registers a thread, in the step that stores them
  static constexpr bool I8_AHEAD = HD <= 128;
  static constexpr int TQ = BR * HD, TK = BK * HD;  // tile elements
  static constexpr int BYTES = (TQ + 4 * TK) * 2;
};

// Element offset of column `col`'s row in one kv head's pool slice.
__device__ __forceinline__ size_t pool_row(const int* bt, int P, int col) {
  return (static_cast<size_t>(bt[col / P]) * P + col % P);
}

// bf16 pools: one tile's K and V columns [k_start, k_start + BK) by
// cp.async into swizzled tiles; columns at or past `limit` are zero-filled.
template <int HD, int BK, int NT>
__device__ __forceinline__ void gather_async(uint32_t dk, uint32_t dv,
                                             const bf16* kp, const bf16* vp,
                                             const int* bt, int P,
                                             int k_start, int limit,
                                             int tid) {
  constexpr int CPR = HD / 8;  // 16-byte chunks a row
  static_assert((BK * CPR) % NT == 0, "tile chunks must divide threads");
#pragma unroll
  for (int it = 0; it < BK * CPR / NT; ++it) {
    const int i = tid + it * NT, r = i / CPR, c = i % CPR;
    const int col = k_start + r;
    const bool ok = col < limit;
    const size_t at = ok ? pool_row(bt, P, col) * HD + c * 8 : 0;
    cp_async16(tile_addr<HD>(dk, r, c), kp + at, ok);
    cp_async16(tile_addr<HD>(dv, r, c), vp + at, ok);
  }
}

// int8 pools: one tile's K and V columns as 16-byte vectors (16 values
// each) held in registers, then converted to bf16 into swizzled tiles.
template <int HD, int BK, int NT>
struct I8Regs {
  static constexpr int VPR = HD / 16;  // vectors a row
  static constexpr int PER = BK * VPR / NT;
  static_assert((BK * VPR) % NT == 0, "tile vectors must divide threads");
  uint4 k[PER], v[PER];

  // Issue the loads of columns [k_start, k_start + BK); columns at or past
  // `limit` read nothing and hold zeros.
  __device__ __forceinline__ void load(const int8_t* kp, const int8_t* vp,
                                       const int* bt, int P, int k_start,
                                       int limit, int tid) {
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int i = tid + u * NT, col = k_start + i / VPR;
      k[u] = v[u] = make_uint4(0u, 0u, 0u, 0u);
      if (col < limit) {
        const size_t at = pool_row(bt, P, col) * HD + (i % VPR) * 16;
        k[u] = *reinterpret_cast<const uint4*>(kp + at);
        v[u] = *reinterpret_cast<const uint4*>(vp + at);
      }
    }
  }

  // 16 int8 values -> 16 bf16 (exact), as two swizzled 16-byte chunks.
  static __device__ __forceinline__ void put(uint32_t base, int r, int c2,
                                             uint4 x) {
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
    uint32_t o[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const uint32_t word = w[e / 2];
      const int sh = (e % 2) * 16;  // bytes 2e and 2e + 1 of the vector
      const int lo = static_cast<int>(word << (24 - sh)) >> 24;
      const int hi = static_cast<int>(word << (16 - sh)) >> 24;
      o[e] = pack_bf16(static_cast<float>(lo), static_cast<float>(hi));
    }
    st_shared16(tile_addr<HD>(base, r, c2),
                make_uint4(o[0], o[1], o[2], o[3]));
    st_shared16(tile_addr<HD>(base, r, c2 + 1),
                make_uint4(o[4], o[5], o[6], o[7]));
  }

  __device__ __forceinline__ void store(uint32_t dk, uint32_t dv,
                                        int tid) const {
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int i = tid + u * NT, r = i / VPR, c2 = (i % VPR) * 2;
      put(dk, r, c2, k[u]);
      put(dv, r, c2, v[u]);
    }
  }
};

template <typename PT, int HD>
__global__ void __launch_bounds__(TcChunk<HD>::NT, TcChunk<HD>::MIN_BLOCKS)
paged_chunk_tc_kernel(const bf16* __restrict__ q,
                      const PT* __restrict__ k_pages,
                      const PT* __restrict__ v_pages,
                      const int* __restrict__ block_tables,
                      const int* __restrict__ chunk_starts,
                      const int* __restrict__ seq_lens,
                      const float* __restrict__ k_scale,
                      const float* __restrict__ v_scale,
                      bf16* __restrict__ out,
                      float* __restrict__ part_acc,
                      float* __restrict__ part_ml, int C, int H, int KV,
                      int N, int P, int MP, int nsplit, float scale) {
  using T = TcChunk<HD>;
  constexpr bool I8 = sizeof(PT) == 1;
  constexpr int NS = T::BK / 8;  // score n-tiles a warp
  constexpr int ND = HD / 8;     // output n-tiles a warp
  constexpr int KQ = HD / 16;    // k steps of q . k^T
  constexpr int CPR = HD / 8;    // 16-byte chunks a row

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);  // [BR][HD]
  bf16* sk = sq + T::TQ;                     // [2][BK][HD]
  bf16* sv = sk + 2 * T::TK;                 // [2][BK][HD]
  const uint32_t aq = smem_u32(sq), ak = smem_u32(sk), av = smem_u32(sv);

  const int G = H / KV;
  const int rows = C * G;
  const int split = blockIdx.x % nsplit;
  const int rb = blockIdx.x / nsplit * T::BR;  // the block's first row
  const int kv = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int start = chunk_starts[b];
  const int n = seq_lens[b];
  const int* bt = block_tables + static_cast<size_t>(b) * MP;
  const size_t pool_off = static_cast<size_t>(kv) * N * P * HD;
  const PT* kp = k_pages + pool_off;
  const PT* vp = v_pages + pool_off;
  const float scale_log2 = scale * k_scale[kv] * LOG2E;

  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  // rows r0 and r0 + 8 of this thread: running max of the raw scores and
  // this lane's part of the running sum
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const int r0 = warp * 16 + (lane >> 2);
  const int pos[2] = {start + (rb + r0) / G, start + (rb + r0 + 8) / G};

  // causal skip: no row of this tile sees a column past its last row
  const int last_row = min(rb + T::BR, rows) - 1;
  const int limit = min(n, start + last_row / G + 1);
  const int first_pos = start + rb / G;
  const int n_tiles = limit > 0 ? (limit + T::BK - 1) / T::BK : 0;
  // this block's share of the tiles: [t0, t0 + nt), whole tiles
  const int per = (n_tiles + nsplit - 1) / nsplit;
  const int t0 = min(split * per, n_tiles);
  const int nt = min(t0 + per, n_tiles) - t0;
  I8Regs<HD, T::BK, T::NT> regs;
  if (nt > 0) {
#pragma unroll
    for (int it = 0; it < T::BR * CPR / T::NT; ++it) {
      const int i = tid + it * T::NT, r = i / CPR, c = i % CPR;
      const int row = rb + r;
      const bool ok = row < rows;
      const size_t at =
          ok ? ((static_cast<size_t>(b) * C + row / G) * H + kv * G +
                row % G) * HD + c * 8
             : 0;
      cp_async16(tile_addr<HD>(aq, r, c), q + at, ok);
    }
    if constexpr (I8) {
      if constexpr (T::I8_AHEAD)
        regs.load(kp, vp, bt, P, t0 * T::BK, limit, tid);
    } else {
      gather_async<HD, T::BK, T::NT>(ak, av, kp, vp, bt, P, t0 * T::BK,
                                     limit, tid);
    }
    cp_commit();
  }

  uint32_t fq[T::Q_REGS ? KQ : 1][4];
  for (int t = 0; t < nt; ++t) {
    const uint32_t kt = ak + (t & 1) * T::TK * 2;
    const uint32_t vt = av + (t & 1) * T::TK * 2;
    const int k_start = (t0 + t) * T::BK;
    if constexpr (I8) {
      if constexpr (!T::I8_AHEAD)
        regs.load(kp, vp, bt, P, k_start, limit, tid);
      regs.store(kt, vt, tid);  // tile t
      if constexpr (T::I8_AHEAD) {
        if (t + 1 < nt)
          regs.load(kp, vp, bt, P, k_start + T::BK, limit, tid);
      }
      cp_wait_all();  // the q tile
    } else {
      if (t + 1 < nt)  // the next tile, into the other stage
        gather_async<HD, T::BK, T::NT>(
            ak + ((t + 1) & 1) * T::TK * 2, av + ((t + 1) & 1) * T::TK * 2,
            kp, vp, bt, P, k_start + T::BK, limit, tid);
      cp_commit();
      cp_wait_one();
    }
    __syncthreads();
    const int ar = warp * 16 + (lane & 15);
    if constexpr (T::Q_REGS) {
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
      if constexpr (T::Q_REGS) {
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

    // position and length masks, on edge tiles only
    if (k_start + T::BK - 1 > first_pos || k_start + T::BK > n) {
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k_start + j * 8 + 2 * (lane & 3) + (e & 1);
          if (!(col <= pos[e >> 1] && col < n)) s[j][e] = -INFINITY;
        }
    }

    // online softmax on the fragments; P in bf16 as P . V's A operand
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
      // column 0 is valid for every row once n > 0, so mx is finite from
      // the first tile on; the guard keeps -inf - -inf out anyway
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
    uint32_t fp[T::BK / 16][4];
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
    for (int kc = 0; kc < T::BK / 16; ++kc) {
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
  const float vs = v_scale[kv];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = rb + r0 + half * 8;
    if (row >= rows) continue;
    if (nsplit > 1) {  // this split's (m, l, acc) for the merge kernel
      const size_t pr =
          ((static_cast<size_t>(b) * KV + kv) * nsplit + split) * rows + row;
      float* pa = part_acc + pr * HD + 2 * (lane & 3);
#pragma unroll
      for (int j = 0; j < ND; ++j)
        *reinterpret_cast<float2*>(pa + j * 8) =
            make_float2(acc[j][2 * half], acc[j][2 * half + 1]);
      if ((lane & 3) == 0)
        *reinterpret_cast<float2*>(part_ml + 2 * pr) =
            make_float2(m[half], l[half]);
      continue;
    }
    const float lh = l[half] == 0.f ? 1.f : l[half];  // no column: 0
    const int c = row / G, g = row % G;
    bf16* dst = out +
                ((static_cast<size_t>(b) * C + c) * H + kv * G + g) * HD +
                2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < ND; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + j * 8) = __floats2bfloat162_rn(
          acc[j][2 * half] / lh * vs, acc[j][2 * half + 1] / lh * vs);
  }
}

// Merge the nsplit partial (m, l, acc) of each row, as flash decoding
// does: w_s = exp2((m_s - M) * scale'), out = sum w_s acc_s / sum w_s l_s
// * v_scale.  One warp a row, HD / 32 values a lane.
template <int HD>
__global__ void __launch_bounds__(128)
paged_chunk_merge_kernel(const float* __restrict__ part_acc,
                         const float* __restrict__ part_ml,
                         const float* __restrict__ k_scale,
                         const float* __restrict__ v_scale,
                         bf16* __restrict__ out, int C, int H, int KV,
                         int nsplit, float scale) {
  constexpr int PER = HD / 32;
  const int G = H / KV, rows = C * G;
  const int row = blockIdx.x * 4 + threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kv = blockIdx.y, b = blockIdx.z;
  if (row >= rows) return;
  const float scale_log2 = scale * k_scale[kv] * LOG2E;
  const size_t base = (static_cast<size_t>(b) * KV + kv) * nsplit * rows + row;
  float mx = -INFINITY;
  for (int s = 0; s < nsplit; ++s)
    mx = fmaxf(mx, part_ml[2 * (base + static_cast<size_t>(s) * rows)]);
  float acc[PER], l_sum = 0.f;
#pragma unroll
  for (int e = 0; e < PER; ++e) acc[e] = 0.f;
  if (mx != -INFINITY) {  // else no split saw a valid column: 0
    const float mb = mx * scale_log2;
    for (int s = 0; s < nsplit; ++s) {
      const size_t pr = base + static_cast<size_t>(s) * rows;
      const float w = exp2f(part_ml[2 * pr] * scale_log2 - mb);
      l_sum += w * part_ml[2 * pr + 1];
      const float* pa = part_acc + pr * HD + lane * PER;
#pragma unroll
      for (int e = 0; e < PER; ++e) acc[e] += w * pa[e];
    }
  }
  const float lh = l_sum == 0.f ? 1.f : l_sum;
  const float vs = v_scale[kv];
  const int c = row / G, g = row % G;
  bf16* dst = out + ((static_cast<size_t>(b) * C + c) * H + kv * G + g) * HD +
              lane * PER;
#pragma unroll
  for (int e = 0; e < PER; ++e) dst[e] = __float2bfloat16_rn(acc[e] / lh * vs);
}

struct ChunkArgs {
  const void *q, *kp, *vp;
  const int *bt, *starts, *lens;
  const float *ks, *vs;
  void* out;
  float *part_acc, *part_ml;
  int B, C, H, KV, N, P, MP, nsplit;
  float scale;
  cudaStream_t stream;
};

template <typename PT, int HD>
int launch(const ChunkArgs& a) {
  using T = TcChunk<HD>;
  auto kernel = paged_chunk_tc_kernel<PT, HD>;
  cudaError_t err = dv_allow_smem(kernel, T::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = a.C * (a.H / a.KV);
  dim3 grid((rows + T::BR - 1) / T::BR * a.nsplit, a.KV, a.B);
  kernel<<<grid, T::NT, T::BYTES, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const PT*>(a.kp),
      static_cast<const PT*>(a.vp), a.bt, a.starts, a.lens, a.ks, a.vs,
      static_cast<bf16*>(a.out), a.part_acc, a.part_ml, a.C, a.H, a.KV, a.N,
      a.P, a.MP, a.nsplit, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.nsplit == 1) return static_cast<int>(err);
  dim3 merge_grid((rows + 3) / 4, a.KV, a.B);
  paged_chunk_merge_kernel<HD><<<merge_grid, 128, 0, a.stream>>>(
      a.part_acc, a.part_ml, a.ks, a.vs, static_cast<bf16*>(a.out), a.C, a.H,
      a.KV, a.nsplit, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename PT>
int dispatch_hd(const ChunkArgs& a, int HD) {
  switch (HD) {
    case 32: return launch<PT, 32>(a);
    case 64: return launch<PT, 64>(a);
    case 128: return launch<PT, 128>(a);
    case 256: return launch<PT, 256>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename PT>
int info_hd(int HD, int* out) {
  switch (HD) {
    case 32: return dv_kernel_info(paged_chunk_tc_kernel<PT, 32>, TcChunk<32>::NT, TcChunk<32>::BYTES, out);
    case 64: return dv_kernel_info(paged_chunk_tc_kernel<PT, 64>, TcChunk<64>::NT, TcChunk<64>::BYTES, out);
    case 128: return dv_kernel_info(paged_chunk_tc_kernel<PT, 128>, TcChunk<128>::NT, TcChunk<128>::BYTES, out);
    case 256: return dv_kernel_info(paged_chunk_tc_kernel<PT, 256>, TcChunk<256>::NT, TcChunk<256>::BYTES, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int dv_paged_chunk_info(int HD, int pool_dtype, int* out) {
  if (pool_dtype == DV_BF16) return info_hd<bf16>(HD, out);
  if (pool_dtype == DV_I8) return info_hd<int8_t>(HD, out);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int dv_paged_chunk(const void* q, const void* k_pages,
                              const void* v_pages, const void* block_tables,
                              const void* chunk_starts, const void* seq_lens,
                              const void* k_scale, const void* v_scale,
                              void* out, void* part_acc, void* part_ml,
                              int B, int C, int H, int KV, int N, int P,
                              int MP, int HD, int q_dtype, int pool_dtype,
                              int nsplit, float scale, void* stream) {
  if (B <= 0 || C <= 0 || KV <= 0 || P <= 0 || MP <= 0 || H % KV != 0 ||
      H / KV > MAXG || q_dtype != DV_BF16 || nsplit < 1 ||
      (nsplit > 1 && (part_acc == nullptr || part_ml == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const ChunkArgs a{q, k_pages, v_pages,
                    static_cast<const int*>(block_tables),
                    static_cast<const int*>(chunk_starts),
                    static_cast<const int*>(seq_lens),
                    static_cast<const float*>(k_scale),
                    static_cast<const float*>(v_scale), out,
                    static_cast<float*>(part_acc),
                    static_cast<float*>(part_ml), B, C, H, KV, N, P, MP,
                    nsplit, scale, static_cast<cudaStream_t>(stream)};
  if (pool_dtype == DV_BF16) return dispatch_hd<bf16>(a, HD);
  if (pool_dtype == DV_I8) return dispatch_hd<int8_t>(a, HD);
  return static_cast<int>(cudaErrorInvalidValue);
}
