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
// Design: one block of 128 threads per (kv head, sequence), as both TPU
// grids have.  The block streams the sequence's live pages through shared
// memory with cp.async double buffering: one page of K and one of V per
// stage (2 x P x HD x itemsize; 32 KB at P=64, HD=128 in bf16, so two
// stages take 64 KB, 128 KB at HD=256), sized from P, HD and the pool
// dtype at launch; only the rows < len of the last page are copied.  Each
// page takes three steps between barriers:
//   1. scores: an item is one column's 32 channels for all G heads, so a
//      column is HD/32 items; neighbouring threads take neighbouring
//      columns, reading 16-byte pieces of K rows padded by 16 bytes (no
//      bank conflicts) and the same q (kept in shared memory as float, the
//      K scale folded in: a broadcast); no shuffles;
//   2. softmax: one warp per head sums the items, updates the running max
//      and sum, and leaves p in a [G, P] fp32 tile;
//   3. P @ V: each thread owns one channel pair of every head and a
//      contiguous group of columns (256/HD groups), four columns at a time
//      (p as float4); the groups' partial sums merge at the end.
// The V scale folds into the final normalize, as in the TPU kernels;
// l == 0 gives l = 1.
//
// The write (WRITE=true): the block stores its kv head's new row into the
// pool, and when it stages the page that holds that row it takes the row
// from new_k/new_v instead of copying it back from the pool, so no block
// ever reads what it has just written (a cp.async read of a row written
// by the same block a moment earlier would need an ordering argument;
// this needs none).  Inactive scheduler slots all point at trash page 0
// and race on its row 0, as in the TPU kernel; their outputs are
// discarded.
//
// Bound on this card: HBM bytes.  At the report lane's shape (B=8, H=6,
// KV=2, HD=128, P=64, len 1024, bf16 pools) the live K/V rows are 8.39 MB,
// 2.5 us at 3.35 TB/s; the math is ~1 flop per byte.  The grid has only
// B x KV = 16 blocks there: 116 SMs idle, and on each busy SM four warps
// cannot hide the latency of a page's three phases (measured ~4 us a
// page; a third cp.async stage changed it by 7 %), so latency, not the
// bytes, bounds this design.  Left for later: splitting the columns over
// more blocks (split-K with a merge pass) and TMA page copies.

#include "common.cuh"

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
                       __nv_bfloat16* __restrict__ out, int H, int KV, int N,
                       int P, int MP, float scale) {
  using S = Shape<PT, HD>;
  extern __shared__ __align__(16) unsigned char smem[];

  const int kv = blockIdx.x, b = blockIdx.y;
  const int G = H / KV;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int PP = (P + 3) & ~3;  // score row stride, a multiple of 4
  const int* bt = block_tables + static_cast<size_t>(b) * MP;
  const int len = seq_lens[b];
  const int n = min(max(len, 0), MP * P);  // columns attended
  const int npages = (n + P - 1) / P;
  const size_t row_src = (static_cast<size_t>(b) * KV + kv) * HD;
  const int wpos = len - 1;  // the written row (WRITE only)
  const bool write = WRITE && wpos >= 0 && wpos < MP * P;
  const int wpage = write ? wpos / P : -1, woff = write ? wpos % P : -1;

  PT* kbuf = reinterpret_cast<PT*>(smem);  // [2][P][KS]
  PT* vbuf = kbuf + 2 * P * S::KS;         // [2][PP][HD]
  float* qsm = reinterpret_cast<float*>(vbuf + 2 * PP * HD);  // [G][HD]
  float* part = qsm + G * HD;  // [SPLITS][G][PP] scores; then p in [0]
  float* st_m = part + S::SPLITS * G * PP;  // [MAXG] running max
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
  const float qs = scale * k_scale[kv];
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

  if (npages > 0) stage(0, 0);
  for (int p = 0; p < npages; ++p) {
    const int s = p & 1;
    if (p + 1 < npages) {
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
        part[(sp * G + g) * PP + c] = dot[g];
      }
    }
    __syncthreads();

    // 2) online softmax, one warp per head: sum the items, p into part[0]
    for (int g = warp; g < G; g += NW) {
      float mx = DV_NEG_INF;
      for (int c = lane; c < rows; c += 32) {
        float v = 0.f;
        for (int sp = 0; sp < S::SPLITS; ++sp) v += part[(sp * G + g) * PP + c];
        part[g * PP + c] = v;
        mx = fmaxf(mx, v);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = st_m[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int c = lane; c < PP; c += 32) {
        const float e = c < rows ? expf(part[g * PP + c] - m_new) : 0.f;
        part[g * PP + c] = e;
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
        if (g < G) pg[g] = *reinterpret_cast<const float4*>(part + g * PP + c);
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
    __syncthreads();  // the next iteration refills this stage and part
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
  if (cg == 0) {
    const float vs = v_scale[kv];
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g >= G) break;
      const float l = st_l[g] == 0.f ? 1.f : st_l[g];
      *reinterpret_cast<__nv_bfloat162*>(
          out + (static_cast<size_t>(b) * H + kv * G + g) * HD + 2 * pr) =
          __floats2bfloat162_rn(acc[g][0] / l * vs, acc[g][1] / l * vs);
    }
  }
}

template <bool WRITE, typename PT, int HD>
int launch(const void* q, const void* nk, const void* nv, void* kp, void* vp,
           const int* bt, const int* lens, const float* ks, const float* vs,
           void* out, int B, int H, int KV, int N, int P, int MP, float scale,
           cudaStream_t stream) {
  const size_t bytes = smem_bytes<PT, HD>(P, H / KV);
  if (bytes > 232448) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t attr = dv_allow_smem(
      paged_attention_kernel<WRITE, PT, HD>, static_cast<int>(bytes));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  paged_attention_kernel<WRITE, PT, HD><<<dim3(KV, B), NT, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const PT*>(nk),
      static_cast<const PT*>(nv), static_cast<PT*>(kp), static_cast<PT*>(vp),
      bt, lens, ks, vs, static_cast<__nv_bfloat16*>(out), H, KV, N, P, MP,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <bool WRITE, typename PT>
int dispatch_hd(const void* q, const void* nk, const void* nv, void* kp,
                void* vp, const int* bt, const int* lens, const float* ks,
                const float* vs, void* out, int B, int H, int KV, int N, int P,
                int MP, int HD, float scale, cudaStream_t st) {
  switch (HD) {
    case 32: return launch<WRITE, PT, 32>(q, nk, nv, kp, vp, bt, lens, ks, vs, out, B, H, KV, N, P, MP, scale, st);
    case 64: return launch<WRITE, PT, 64>(q, nk, nv, kp, vp, bt, lens, ks, vs, out, B, H, KV, N, P, MP, scale, st);
    case 128: return launch<WRITE, PT, 128>(q, nk, nv, kp, vp, bt, lens, ks, vs, out, B, H, KV, N, P, MP, scale, st);
    case 256: return launch<WRITE, PT, 256>(q, nk, nv, kp, vp, bt, lens, ks, vs, out, B, H, KV, N, P, MP, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool WRITE>
int dispatch_pool(int pool_dtype, const void* q, const void* nk,
                  const void* nv, void* kp, void* vp, const int* bt,
                  const int* lens, const float* ks, const float* vs, void* out,
                  int B, int H, int KV, int N, int P, int MP, int HD,
                  float scale, cudaStream_t st) {
  if (pool_dtype == DV_BF16)
    return dispatch_hd<WRITE, __nv_bfloat16>(q, nk, nv, kp, vp, bt, lens, ks, vs, out, B, H, KV, N, P, MP, HD, scale, st);
  if (pool_dtype == DV_I8)
    return dispatch_hd<WRITE, int8_t>(q, nk, nv, kp, vp, bt, lens, ks, vs, out, B, H, KV, N, P, MP, HD, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// new_k/new_v are read only when write != 0 (pass null otherwise).
extern "C" int dv_paged_attention(
    const void* q, const void* new_k, const void* new_v, void* k_pages,
    void* v_pages, const void* block_tables, const void* seq_lens,
    const void* k_scale, const void* v_scale, void* out, int B, int H, int KV,
    int N, int P, int MP, int HD, int pool_dtype, int write, float scale,
    void* stream) {
  if (B <= 0 || KV <= 0 || P <= 0 || MP <= 0 || H % KV != 0 ||
      H / KV > MAXG || (write && (new_k == nullptr || new_v == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int* bt = static_cast<const int*>(block_tables);
  const int* lens = static_cast<const int*>(seq_lens);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (write)
    return dispatch_pool<true>(pool_dtype, q, new_k, new_v, k_pages, v_pages, bt, lens, ks, vs, out, B, H, KV, N, P, MP, HD, scale, st);
  return dispatch_pool<false>(pool_dtype, q, new_k, new_v, k_pages, v_pages, bt, lens, ks, vs, out, B, H, KV, N, P, MP, HD, scale, st);
}
