// Paged decode attention on a (kv head, sequence) grid, one page at a time:
// read-only (WRITE=false) or with this step's K/V row written first
// (WRITE=true).
//
// Replaces two kernels of deepvision_tpu/engine/kernels/paged_attention.py:
//   * _paged_kernel (through paged_attention's pallas_call): read-only
//     paged decode attention                                  -> WRITE=false
//   * _fused_kernel (through paged_attention_update(grid_mode="bkv")): the
//     same attention after writing the step's row in place    -> WRITE=true
//
//   q [B, H, HD] bf16 (RoPE applied); pools [KV, N, P, HD] bf16 or int8;
//   block_tables [B, MP] (entries past the live pages may be 0, the trash
//   page); seq_lens [B] counting the current token; k_scale/v_scale [KV]
//   f32 (ones for bf16 pools); new_k/new_v [B, KV, HD] in the pool dtype
//   (int8 rows arrive quantized by the wrapper), read only when WRITE.
//   WRITE: pools[kv, bt[b, (len-1)/P], (len-1)%P] = new row   (in place)
//   out[b, kv*G+g] = softmax_c(q . k_c * HD^-0.5 * k_scale) @ v_c * v_scale
//   over the kv head's G query heads and columns c < len; len 0 gives 0.
//
// Design: 128 threads a block on a grid of (nsplit, KV, B) blocks.  The
// column split, the rule for the written row, the partial layout and the
// merge kernel are decode_split.cuh's, shared with paged_decode.cu (#1):
// block `split` takes a range of whole pages of its (kv head, sequence),
// and with nsplit > 1 a second kernel merges the ranges' fp32 states.
// The block streams its range's pages through shared memory with cp.async
// double buffering: one page of K and one of V per stage (2 x P x HD x
// itemsize; 32 KB at P=64, HD=128 in bf16, so two stages take 64 KB,
// 128 KB at HD=256), sized from P, HD and the pool dtype at launch; only
// the rows < len of the last page are copied.  Three blocks fit an SM at
// HD 128 in bf16 (shared memory), so the split's 256 blocks at the report
// lane's shape are all resident at once.  Each page takes three steps
// between barriers:
//   1. scores: an item is one column's 32 channels for all G heads, so a
//      column is HD/32 items; neighbouring threads take neighbouring
//      columns, reading 16-byte pieces of K rows padded by 16 bytes (no
//      bank conflicts) and the same q (kept in shared memory as float, the
//      K scale folded in: a broadcast); no shuffles;
//   2. softmax: one warp per head sums the items, updates the running max
//      and sum (fp32, expf), and leaves p in a [G, P] fp32 tile;
//   3. P @ V: each thread owns one channel pair of every head and a
//      contiguous group of columns (256/HD groups), four columns at a time
//      (p as float4); the groups' partial sums merge at the end.
// The V scale folds into the final normalize, as in the TPU kernels;
// l == 0 gives l = 1 (len 0: every range empty, the row is 0).
//
// The write (WRITE=true): only the block whose range holds column len - 1
// stores its kv head's new row into the pool, and when it stages the page
// that holds that row it takes the row from new_k/new_v instead of
// copying it back from the pool, so no block ever reads what a block of
// the launch writes.  Inactive scheduler slots all point at trash page 0
// and race on its row 0, as in the TPU kernel; their outputs are
// discarded.
//
// Bound on this card: HBM bytes.  At the report lane's shape (B=8, H=6,
// KV=2, HD=128, P=64, len 1024, bf16 pools) the live K/V rows are 8.39 MB,
// 2.5 us at 3.35 TB/s; the math is ~3 flops a byte.  Unsplit, the grid
// is B x KV = 16 blocks there, and four warps a busy SM cannot hide a
// page's three phases (~4 us a page on an NVIDIA H100 80GB HBM3 at 700 W;
// a third cp.async stage changed it by 7 %): latency, not the bytes,
// bounds it.  The split gives each block one page there: 8.1 us for this
// kernel and 2.2 us for the merge on that card, against 62 us unsplit
// (chip_smoke.py's decode cases).  Left for later: TMA page copies.

#include "decode_split.cuh"

namespace {

constexpr int NT = 128;       // threads per block
constexpr int NW = NT / 32;   // warps
constexpr int MAXG = 8;       // query heads per kv head this kernel takes
constexpr int CHUNK = 32;     // channels a score item sums

template <typename PT, int HD>
struct Shape {
  static constexpr int VEC = 16 / static_cast<int>(sizeof(PT));  // per 16 B
  static constexpr int VPR = HD / VEC;      // 16-byte pieces per row
  static constexpr int KS = HD + VEC;       // K row stride: 16 bytes of pad
  static constexpr int SPLITS = HD / CHUNK; // score items per column
  static constexpr int PAIRS = HD / 2;      // P@V: a thread owns a pair
  static constexpr int CG = NT / PAIRS;     // P@V: column groups (256 / HD)
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <typename PT, int HD>
size_t smem_bytes(int P, int G) {
  using S = Shape<PT, HD>;
  const size_t pp = (P + 3) & ~3;
  return 2 * static_cast<size_t>(P) * S::KS * sizeof(PT) +
         2 * pp * HD * sizeof(PT) +
         (static_cast<size_t>(G) * HD + S::SPLITS * G * pp + 3 * MAXG +
          (S::CG > 1 ? static_cast<size_t>(S::CG) * G * HD : 0)) *
             sizeof(float);
}

template <bool WRITE, typename PT, int HD>
__global__ void __launch_bounds__(NT)
paged_attention_kernel(const __nv_bfloat16* __restrict__ q,
                       const PT* __restrict__ new_k,
                       const PT* __restrict__ new_v, PT* k_pages, PT* v_pages,
                       const int* __restrict__ block_tables,
                       const int* __restrict__ seq_lens,
                       const float* __restrict__ k_scale,
                       const float* __restrict__ v_scale,
                       __nv_bfloat16* __restrict__ out,
                       float* __restrict__ part, int H, int KV, int N, int P,
                       int MP, int nsplit, float scale) {
  using S = Shape<PT, HD>;
  extern __shared__ __align__(16) unsigned char smem[];

  const int split = blockIdx.x, kv = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int PP = (P + 3) & ~3;  // score row stride, a multiple of 4
  const int* bt = block_tables + static_cast<size_t>(b) * MP;
  const int len = seq_lens[b];
  const int n = min(max(len, 0), MP * P);  // columns attended
  // this block's pages [p0, p1) of the sequence (decode_split.cuh)
  const DvColRange r = dv_split_cols(n, P, nsplit, split);
  const int p0 = r.c0 / P, p1 = r.c0 < r.c1 ? (r.c1 + P - 1) / P : p0;
  float* part_ml =  // nsplit > 1: after part_acc's rows
      nsplit > 1 ? part + static_cast<size_t>(gridDim.z) * H * nsplit * HD
                 : nullptr;
  if (p0 >= p1 && nsplit > 1) {  // an empty range: m = -inf, l = 0
    const size_t pr0 = dv_part_row(b, kv, KV, nsplit, split, G, 0);
    if (tid < G) {
      part_ml[2 * (pr0 + tid)] = -INFINITY;
      part_ml[2 * (pr0 + tid) + 1] = 0.f;
    }
    return;
  }
  const size_t row_src = (static_cast<size_t>(b) * KV + kv) * HD;
  const int wpos = len - 1;  // the written row (WRITE only)
  // only the block whose range holds the row writes it and stages it
  const bool write = WRITE && wpos >= r.c0 && wpos < r.c1;
  const int wpage = write ? wpos / P : -1, woff = write ? wpos % P : -1;

  PT* kbuf = reinterpret_cast<PT*>(smem);  // [2][P][KS]
  PT* vbuf = kbuf + 2 * P * S::KS;         // [2][PP][HD]
  float* qsm = reinterpret_cast<float*>(vbuf + 2 * PP * HD);  // [G][HD]
  float* scores = qsm + G * HD;  // [SPLITS][G][PP] scores; then p in [0]
  float* st_m = scores + S::SPLITS * G * PP;  // [MAXG] running max
  float* st_l = st_m + MAXG;                // [MAXG] running sum
  float* st_a = st_l + MAXG;                // [MAXG] this page's rescale
  float* red = st_a + MAXG;                 // [CG][G][HD] when CG > 1

  if (write) {
    const size_t dst =
        ((static_cast<size_t>(kv) * N + bt[wpage]) * P + woff) * HD;
    for (int d = tid; d < HD; d += NT) {
      k_pages[dst + d] = new_k[row_src + d];
      v_pages[dst + d] = new_v[row_src + d];
    }
  }

  // Stage page p (its rows < n) into buffer s.  The written row comes
  // from new_k/new_v, every other row from the pool; V rows past the
  // page's live rows are zeroed (their p is 0, and 0 x garbage could be
  // NaN).
  auto stage = [&](int p, int s) {
    const int rows = min(P, n - p * P);
    const size_t base = (static_cast<size_t>(kv) * N + bt[p]) * P * HD;
    PT* kd = kbuf + s * P * S::KS;
    PT* vd = vbuf + s * PP * HD;
    for (int i = tid; i < rows * S::VPR; i += NT) {
      const int r = i / S::VPR, c = (i % S::VPR) * S::VEC;
      if (WRITE && p == wpage && r == woff) {
        *reinterpret_cast<uint4*>(kd + r * S::KS + c) =
            *reinterpret_cast<const uint4*>(new_k + row_src + c);
        *reinterpret_cast<uint4*>(vd + r * HD + c) =
            *reinterpret_cast<const uint4*>(new_v + row_src + c);
      } else {
        cp_async16(kd + r * S::KS + c, k_pages + base + r * HD + c);
        cp_async16(vd + r * HD + c, v_pages + base + r * HD + c);
      }
    }
    for (int i = tid; i < (PP - rows) * S::VPR; i += NT)
      *reinterpret_cast<uint4*>(vd + (rows + i / S::VPR) * HD +
                                (i % S::VPR) * S::VEC) =
          make_uint4(0u, 0u, 0u, 0u);
    cp_async_commit();
  };

  // each head's q in shared memory, the K scale folded in
  const float qs = scale * (k_scale ? k_scale[kv] : 1.f);
  for (int i = tid; i < G * HD; i += NT)
    qsm[i] = dv_to_f32(q[(static_cast<size_t>(b) * H + kv * G) * HD + i]) * qs;

  // P@V ownership: channels 2 * pr, 2 * pr + 1 of column group cg
  const int pr = tid % S::PAIRS, cg = tid / S::PAIRS;
  float acc[MAXG][2];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) acc[g][0] = acc[g][1] = 0.f;
  if (tid < MAXG) {
    st_m[tid] = DV_NEG_INF;
    st_l[tid] = 0.f;
  }
  __syncthreads();

  if (p0 < p1) stage(p0, 0);
  for (int p = p0; p < p1; ++p) {
    const int s = (p - p0) & 1;
    if (p + 1 < p1) {
      stage(p + 1, s ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int rows = min(P, n - p * P);
    const PT* kt = kbuf + s * P * S::KS;
    const PT* vt = vbuf + s * PP * HD;

    // 1) scores: an item is one column's CHUNK channels for all G heads;
    //    neighbouring lanes take neighbouring columns (padded rows: no
    //    bank conflicts) and read the same q (a broadcast)
    for (int it = tid; it < rows * S::SPLITS; it += NT) {
      const int c = it % rows, sp = it / rows;
      const PT* kr = kt + c * S::KS + sp * CHUNK;
      const float* qc = qsm + sp * CHUNK;
      float dot[MAXG];
#pragma unroll
      for (int g = 0; g < MAXG; ++g) dot[g] = 0.f;
#pragma unroll
      for (int v = 0; v < CHUNK / S::VEC; ++v) {
        float kf[S::VEC];
        Unpack<PT>::run(*reinterpret_cast<const uint4*>(kr + v * S::VEC), kf);
#pragma unroll
        for (int g = 0; g < MAXG; ++g) {
          if (g >= G) break;
          const float4* q4 =
              reinterpret_cast<const float4*>(qc + g * HD + v * S::VEC);
#pragma unroll
          for (int e = 0; e < S::VEC / 4; ++e) {
            const float4 qq = q4[e];
            dot[g] = fmaf(qq.x, kf[4 * e], dot[g]);
            dot[g] = fmaf(qq.y, kf[4 * e + 1], dot[g]);
            dot[g] = fmaf(qq.z, kf[4 * e + 2], dot[g]);
            dot[g] = fmaf(qq.w, kf[4 * e + 3], dot[g]);
          }
        }
      }
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g >= G) break;
        scores[(sp * G + g) * PP + c] = dot[g];
      }
    }
    __syncthreads();

    // 2) online softmax, one warp per head: sum the items, p into scores[0]
    for (int g = warp; g < G; g += NW) {
      float mx = DV_NEG_INF;
      for (int c = lane; c < rows; c += 32) {
        float v = 0.f;
        for (int sp = 0; sp < S::SPLITS; ++sp)
          v += scores[(sp * G + g) * PP + c];
        scores[g * PP + c] = v;
        mx = fmaxf(mx, v);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = st_m[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int c = lane; c < PP; c += 32) {
        const float e = c < rows ? expf(scores[g * PP + c] - m_new) : 0.f;
        scores[g * PP + c] = e;
        sum += e;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        st_a[g] = alpha;
        st_l[g] = st_l[g] * alpha + sum;
        st_m[g] = m_new;
      }
    }
    __syncthreads();

    // 3) rescale and accumulate P @ V over this group's columns, four at
    //    a time (p as float4, a broadcast; V as one channel pair a lane)
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g >= G) break;
      const float a = st_a[g];
      acc[g][0] *= a;
      acc[g][1] *= a;
    }
    const int per = ((PP + S::CG - 1) / S::CG + 3) & ~3;
    const int c_end = min(cg * per + per, PP);
    for (int c = cg * per; c < c_end; c += 4) {
      float4 pg[MAXG];
#pragma unroll
      for (int g = 0; g < MAXG; ++g)
        if (g < G)
          pg[g] = *reinterpret_cast<const float4*>(scores + g * PP + c);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float2 v = Unpack<PT>::pair(vt + (c + u) * HD + 2 * pr);
#pragma unroll
        for (int g = 0; g < MAXG; ++g) {
          if (g >= G) break;
          const float pv = u == 0 ? pg[g].x : u == 1 ? pg[g].y
                         : u == 2 ? pg[g].z : pg[g].w;
          acc[g][0] = fmaf(pv, v.x, acc[g][0]);
          acc[g][1] = fmaf(pv, v.y, acc[g][1]);
        }
      }
    }
    __syncthreads();  // the next iteration refills this stage and scores
  }

  // merge the column groups' partial sums, normalize, store
  if (S::CG > 1) {
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g >= G) break;
      red[(cg * G + g) * HD + 2 * pr] = acc[g][0];
      red[(cg * G + g) * HD + 2 * pr + 1] = acc[g][1];
    }
    __syncthreads();
    if (cg == 0) {
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g >= G) break;
        float a0 = 0.f, a1 = 0.f;
        for (int j = 0; j < S::CG; ++j) {
          a0 += red[(j * G + g) * HD + 2 * pr];
          a1 += red[(j * G + g) * HD + 2 * pr + 1];
        }
        acc[g][0] = a0;
        acc[g][1] = a1;
      }
    }
  }
  if (cg == 0 && nsplit == 1) {
    const float vs = v_scale ? v_scale[kv] : 1.f;
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g >= G) break;
      const float l = st_l[g] == 0.f ? 1.f : st_l[g];
      *reinterpret_cast<__nv_bfloat162*>(
          out + (static_cast<size_t>(b) * H + kv * G + g) * HD + 2 * pr) =
          __floats2bfloat162_rn(acc[g][0] / l * vs, acc[g][1] / l * vs);
    }
  } else if (cg == 0) {  // this split's unnormalised state for the merge
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g >= G) break;
      const size_t prow = dv_part_row(b, kv, KV, nsplit, split, G, g);
      *reinterpret_cast<float2*>(part + prow * HD + 2 * pr) =
          make_float2(acc[g][0], acc[g][1]);
      if (pr == 0) {
        part_ml[2 * prow] = st_m[g];
        part_ml[2 * prow + 1] = st_l[g];
      }
    }
  }
}

struct PagedArgs {
  const void *q, *nk, *nv;
  void *kp, *vp;
  const int *bt, *lens;
  const float *ks, *vs;
  void* out;
  float* part;
  int B, H, KV, N, P, MP, nsplit;
  float scale;
  cudaStream_t stream;
};

template <bool WRITE, typename PT, int HD>
int launch(const PagedArgs& a) {
  auto kernel = paged_attention_kernel<WRITE, PT, HD>;
  const size_t bytes = smem_bytes<PT, HD>(a.P, a.H / a.KV);
  if (bytes > 232448) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = dv_allow_smem(kernel, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(a.nsplit, a.KV, a.B), NT, bytes, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const PT*>(a.nk),
      static_cast<const PT*>(a.nv), static_cast<PT*>(a.kp),
      static_cast<PT*>(a.vp), a.bt, a.lens, a.ks, a.vs,
      static_cast<__nv_bfloat16*>(a.out), a.part, a.H, a.KV, a.N, a.P, a.MP,
      a.nsplit, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.nsplit == 1) return static_cast<int>(err);
  return dv_launch_decode_merge<HD>(a.part, a.vs, a.out, a.B, a.H, a.KV,
                                    a.nsplit, a.stream);
}

template <bool WRITE, typename PT>
int dispatch_hd(const PagedArgs& a, int HD) {
  switch (HD) {
    case 32: return launch<WRITE, PT, 32>(a);
    case 64: return launch<WRITE, PT, 64>(a);
    case 128: return launch<WRITE, PT, 128>(a);
    case 256: return launch<WRITE, PT, 256>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool WRITE>
int dispatch_pool(const PagedArgs& a, int HD, int pool_dtype) {
  if (pool_dtype == DV_BF16) return dispatch_hd<WRITE, __nv_bfloat16>(a, HD);
  if (pool_dtype == DV_I8) return dispatch_hd<WRITE, int8_t>(a, HD);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename PT, int HD>
int info(int write, int P, int G, int* out) {
  const int bytes = static_cast<int>(smem_bytes<PT, HD>(P, G));
  if (write)
    return dv_kernel_info(paged_attention_kernel<true, PT, HD>, NT, bytes,
                          out);
  return dv_kernel_info(paged_attention_kernel<false, PT, HD>, NT, bytes,
                        out);
}

template <typename PT>
int info_hd(int HD, int write, int P, int G, int* out) {
  switch (HD) {
    case 32: return info<PT, 32>(write, P, G, out);
    case 64: return info<PT, 64>(write, P, G, out);
    case 128: return info<PT, 128>(write, P, G, out);
    case 256: return info<PT, 256>(write, P, G, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The kernel for HD, pool dtype and write at page size P and group G, as
// the card runs it (dv_kernel_info's out[0..4]).
extern "C" int dv_paged_attention_info(int HD, int pool_dtype, int write,
                                       int P, int G, int* out) {
  if (P <= 0 || G <= 0 || G > MAXG)
    return static_cast<int>(cudaErrorInvalidValue);
  if (pool_dtype == DV_BF16)
    return info_hd<__nv_bfloat16>(HD, write, P, G, out);
  if (pool_dtype == DV_I8) return info_hd<int8_t>(HD, write, P, G, out);
  return static_cast<int>(cudaErrorInvalidValue);
}

// new_k/new_v are read only when write != 0 (pass null otherwise); part:
// B * KV * nsplit * G * (HD + 2) floats of scratch when nsplit > 1 (null
// otherwise).
extern "C" int dv_paged_attention(
    const void* q, const void* new_k, const void* new_v, void* k_pages,
    void* v_pages, const void* block_tables, const void* seq_lens,
    const void* k_scale, const void* v_scale, void* out, void* part, int B,
    int H, int KV, int N, int P, int MP, int HD, int pool_dtype, int write,
    int nsplit, float scale, void* stream) {
  if (B <= 0 || KV <= 0 || P <= 0 || MP <= 0 || H % KV != 0 ||
      H / KV > MAXG || (write && (new_k == nullptr || new_v == nullptr)) ||
      nsplit < 1 || nsplit > DV_MAX_SPLITS ||
      (nsplit > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const PagedArgs a{q, new_k, new_v, k_pages, v_pages,
                    static_cast<const int*>(block_tables),
                    static_cast<const int*>(seq_lens),
                    static_cast<const float*>(k_scale),
                    static_cast<const float*>(v_scale), out,
                    static_cast<float*>(part), B, H, KV, N, P, MP, nsplit,
                    scale, static_cast<cudaStream_t>(stream)};
  return write ? dispatch_pool<true>(a, HD, pool_dtype)
               : dispatch_pool<false>(a, HD, pool_dtype);
}
