// Fused paged-KV decode step: in-place row write + paged attention, with
// the columns split over blocks.
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
// Bound on this card: HBM bytes.  Each step must read the live K/V rows
// (2 * len * HD * itemsize per kv head and sequence; 8.39 MB at the report
// lane's shape, B=8, KV=2, HD=128, len 1024, bf16: 2.5 us at 3.35 TB/s);
// the math is ~3 flops a byte, and G <= 8 query rows a kv head would
// leave an mma tile mostly padding, so the design serves bandwidth.
//
// Design:
// - Grid (nsplit, KV, B), 4 warps a block.  The column split, the rule for
//   the written row, the partial layout and the merge kernel are
//   decode_split.cuh's, shared with paged_attention.cu.  The wrapper picks
//   nsplit (16 at the report lane's shape: 256 blocks, one page each; the
//   engine's runner counts only the slots that decode).
// - Loads are 16 bytes a lane: a column's row is HD / VEC lanes (VEC = 8
//   bf16 or 16 int8 values), so a warp takes 32 * VEC / HD columns at once
//   (two at HD 128 bf16, four for int8, one at HD 256 bf16) and each lane
//   owns the same VEC channels of every column it takes.  A step is U such
//   loads a lane; the next step's K/V rows are loaded while this one is
//   computed, and its block-table entries one step earlier still; q, its
//   scale and the length are loaded together at the start.
// - The kernel is templated on GT, the heads it computes (G rounded up to
//   2, 3, 4 or 8), so every loop over heads is unrolled without a branch:
//   with a runtime bound the compiler serialised the (column, head) chains
//   and the kernel took 10.4 us at the report shape on an NVIDIA H100
//   80GB HBM3 (700 W) against 8.0 us templated (chip_smoke.py's decode
//   cases).  A step's partial dot products are summed over a column's
//   lanes level by level (xor shuffles), all (column, head) pairs at each
//   level together.
// - q sits in shared memory as float, the scale folded in (HD^-0.5 *
//   k_scale; a null scale is 1), read as a broadcast: neighbouring column
//   groups of a warp read the same channels.  Each lane group keeps its
//   own online softmax (fp32, expf) for the GT heads, updated once a step;
//   the groups of a warp merge by shuffles, the warps through shared
//   memory.
// - The block whose range holds column len - 1 writes the step's K/V row
//   into its page and takes that column from new_k/new_v; no block reads
//   it from the pool.  Inactive scheduler slots (len 1, block table all
//   trash page 0) race on that page's row 0, as in the TPU kernel; their
//   outputs are discarded.
// - nsplit 1 normalises in the block (l == 0 -> 1) and launches no merge.
//
// On that card at the report shape: 8.1 us for this kernel and 2.2 us for
// the merge; the same for int8 pools with half the bytes, so the work
// after each dependent load, not the bandwidth, bounds it (PERF.md).
// Left for later: TMA page copies, int8 rows quantized here rather than
// by the wrapper, and a merge folded into the last block to finish (it
// costs a second launch a layer when nsplit > 1).

#include "decode_split.cuh"

namespace {

constexpr int NW = 4;        // warps a block
constexpr int NT = NW * 32;  // threads a block
constexpr int MAXG = 8;      // query heads per kv head this kernel takes

// GT: the query heads a kv head's block computes, G rounded up to 2, 3, 4
// or 8 (heads past G run on q = 0 and are never written), so every loop
// over heads is unrolled without a branch.
template <typename PT, int HD, int GT>
struct Dec {
  static constexpr int VEC = 16 / static_cast<int>(sizeof(PT));  // a lane
  static constexpr int LPC = HD / VEC;     // lanes a column
  static constexpr int CPW = 32 / LPC;     // columns a warp at once
  static constexpr int STEP = NW * CPW;    // columns a block at once
  // columns a lane loads at once (a warp's 8 KB of K/V rows in flight at
  // GT <= 4, two steps' worth); fewer at GT 8, where the accumulators
  // take GT x VEC registers
  static constexpr int U = (GT > 4 ? 2 : 4) / (sizeof(PT) == 1 ? 2 : 1);
  static_assert(LPC >= 1 && LPC <= 32, "a row is 1 to 32 lanes");
};

template <typename PT, int HD, int GT>
__global__ void __launch_bounds__(NT)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q,
                    const PT* __restrict__ new_k,
                    const PT* __restrict__ new_v, PT* k_pages, PT* v_pages,
                    const int* __restrict__ block_tables,
                    const int* __restrict__ seq_lens,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    __nv_bfloat16* __restrict__ out, float* __restrict__ part,
                    int H, int KV, int N, int P, int MP, int nsplit,
                    float scale) {
  using S = Dec<PT, HD, GT>;
  constexpr int VEC = S::VEC, U = S::U;
  __shared__ __align__(16) float qsm[GT * HD];
  __shared__ __align__(16) float sm_acc[NW][GT * HD];
  __shared__ float sm_m[NW][GT];
  __shared__ float sm_l[NW][GT];

  const int split = blockIdx.x, kv = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;  // <= GT
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sub = lane / S::LPC, ch = (lane % S::LPC) * VEC;
  // q (the scale folded in), its scale and the length are loaded at once
  const int len = seq_lens[b];
  const float qs = scale * (k_scale ? k_scale[kv] : 1.f);
  const __nv_bfloat16* qb = q + (static_cast<size_t>(b) * H + kv * G) * HD;
  for (int i = tid; i < GT * HD; i += NT)
    qsm[i] = i < G * HD ? dv_to_f32(qb[i]) * qs : 0.f;
  const int n = min(max(len, 0), MP * P);
  const DvColRange r = dv_split_cols(n, P, nsplit, split);
  float* part_ml =  // nsplit > 1: after part_acc's rows
      nsplit > 1 ? part + static_cast<size_t>(gridDim.z) * H * nsplit * HD
                 : nullptr;
  if (r.c0 >= r.c1 && nsplit > 1) {  // an empty range: m = -inf, l = 0
    const size_t pr0 = dv_part_row(b, kv, KV, nsplit, split, G, 0);
    if (tid < G) {
      part_ml[2 * (pr0 + tid)] = -INFINITY;
      part_ml[2 * (pr0 + tid) + 1] = 0.f;
    }
    return;
  }
  const int* bt = block_tables + static_cast<size_t>(b) * MP;
  const int wpos = len - 1;  // the written column, if this range holds it
  const bool owns_row = wpos >= r.c0 && wpos < r.c1;
  const size_t row_src = (static_cast<size_t>(b) * KV + kv) * HD;
  const size_t kv_base = static_cast<size_t>(kv) * N;

  if (owns_row) {
    const size_t dst = ((kv_base + bt[wpos / P]) * P + wpos % P) * HD;
    for (int i = tid; i < HD / VEC; i += NT) {
      *reinterpret_cast<uint4*>(k_pages + dst + i * VEC) =
          *reinterpret_cast<const uint4*>(new_k + row_src + i * VEC);
      *reinterpret_cast<uint4*>(v_pages + dst + i * VEC) =
          *reinterpret_cast<const uint4*>(new_v + row_src + i * VEC);
    }
  }
  // the page of each column a lane loads, one step ahead of its K/V rows
  int pg[U];
  auto pages = [&](int base) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int col = base + u * S::STEP + warp * S::CPW + sub;
      pg[u] = col < r.c1 ? __ldg(bt + col / P) : 0;
    }
  };
  // U columns' K and V rows, 16 bytes a lane (column len - 1 from new_k /
  // new_v); zeros past the range
  auto rows = [&](int base, uint4* kr, uint4* vr) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int col = base + u * S::STEP + warp * S::CPW + sub;
      kr[u] = vr[u] = make_uint4(0u, 0u, 0u, 0u);
      if (col < r.c1 && col == wpos) {
        kr[u] = *reinterpret_cast<const uint4*>(new_k + row_src + ch);
        vr[u] = *reinterpret_cast<const uint4*>(new_v + row_src + ch);
      } else if (col < r.c1) {
        const size_t off = ((kv_base + pg[u]) * P + col % P) * HD + ch;
        kr[u] = *reinterpret_cast<const uint4*>(k_pages + off);
        vr[u] = *reinterpret_cast<const uint4*>(v_pages + off);
      }
    }
  };
  pages(r.c0);
  __syncthreads();

  float acc[GT][VEC], m[GT], l[GT];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    m[g] = DV_NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[g][e] = 0.f;
  }

  // software pipeline: a step's rows are loaded while the step before is
  // computed, its pages one step earlier still
  uint4 kr[U], vr[U];
  rows(r.c0, kr, vr);
  pages(r.c0 + S::STEP * U);
  for (int base = r.c0; base < r.c1; base += S::STEP * U) {
    uint4 kn[U], vn[U];
    rows(base + S::STEP * U, kn, vn);
    pages(base + 2 * S::STEP * U);
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      ok[u] = base + u * S::STEP + warp * S::CPW + sub < r.c1;
    // scores: every (column, head) partial dot product first, then their
    // sums over a column's lanes, level by level; -inf past the range
    float s[U][GT];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[VEC];
      Unpack<PT>::run(kr[u], kf);
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        const float4* q4 = reinterpret_cast<const float4*>(qsm + g * HD + ch);
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < VEC / 4; ++e) {
          const float4 qq = q4[e];
          dot = fmaf(qq.x, kf[4 * e], dot);
          dot = fmaf(qq.y, kf[4 * e + 1], dot);
          dot = fmaf(qq.z, kf[4 * e + 2], dot);
          dot = fmaf(qq.w, kf[4 * e + 3], dot);
        }
        s[u][g] = dot;
      }
    }
#pragma unroll
    for (int o = S::LPC / 2; o > 0; o >>= 1)
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int g = 0; g < GT; ++g)
          s[u][g] += __shfl_xor_sync(0xffffffffu, s[u][g], o);
    // online softmax, once per U columns: rescale, then add p * v
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (ok[u]) mx = fmaxf(mx, s[u][g]);
      const float alpha = expf(m[g] - mx);
      l[g] *= alpha;
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[g][e] *= alpha;
      m[g] = mx;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float vf[VEC];
      Unpack<PT>::run(vr[u], vf);
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        const float p = ok[u] ? expf(s[u][g] - m[g]) : 0.f;
        l[g] += p;
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      kr[u] = kn[u];
      vr[u] = vn[u];
    }
  }

  // merge the lane groups of a warp (xor partners own the same channels)
#pragma unroll
  for (int o = S::LPC; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], o);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], o);
      const float mx = fmaxf(m[g], mo);
      const float a = expf(m[g] - mx), c = expf(mo - mx);
      l[g] = fmaf(l[g], a, lo * c);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[g][e], o);
        acc[g][e] = fmaf(acc[g][e], a, ao * c);
      }
      m[g] = mx;
    }
  }
  if (lane < S::LPC) {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) sm_acc[warp][g * HD + ch + e] = acc[g][e];
      if (lane == 0) {
        sm_m[warp][g] = m[g];
        sm_l[warp][g] = l[g];
      }
    }
  }
  __syncthreads();

  // merge the warps; normalise (nsplit 1) or write this split's state
  const float vs = v_scale ? v_scale[kv] : 1.f;
  for (int i = tid; i < G * HD; i += NT) {
    const int g = i / HD, d = i % HD;
    float mx = DV_NEG_INF;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float f = expf(sm_m[w][g] - mx);
      lsum = fmaf(sm_l[w][g], f, lsum);
      a = fmaf(sm_acc[w][i], f, a);
    }
    if (nsplit == 1) {
      const float lh = lsum == 0.f ? 1.f : lsum;
      out[(static_cast<size_t>(b) * H + kv * G) * HD + i] =
          __float2bfloat16_rn(a / lh * vs);
    } else {
      const size_t pr = dv_part_row(b, kv, KV, nsplit, split, G, g);
      part[pr * HD + d] = a;
      if (d == 0) {
        part_ml[2 * pr] = lsum == 0.f ? -INFINITY : mx;
        part_ml[2 * pr + 1] = lsum;
      }
    }
  }
}

struct DecodeArgs {
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

template <typename PT, int HD, int GT>
int launch(const DecodeArgs& a) {
  paged_decode_kernel<PT, HD, GT>
      <<<dim3(a.nsplit, a.KV, a.B), NT, 0, a.stream>>>(
          static_cast<const __nv_bfloat16*>(a.q),
          static_cast<const PT*>(a.nk), static_cast<const PT*>(a.nv),
          static_cast<PT*>(a.kp), static_cast<PT*>(a.vp), a.bt, a.lens, a.ks,
          a.vs, static_cast<__nv_bfloat16*>(a.out), a.part, a.H, a.KV, a.N,
          a.P, a.MP, a.nsplit, a.scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.nsplit == 1) return static_cast<int>(err);
  return dv_launch_decode_merge<HD>(a.part, a.vs, a.out, a.B, a.H, a.KV,
                                    a.nsplit, a.stream);
}

// Launch the kernel (a given) or report how the card runs it (a null):
// one dispatch for both, so the info is always the launched kernel's.
template <typename PT, int HD, int GT>
int run(const DecodeArgs* a, int* info) {
  return a ? launch<PT, HD, GT>(*a)
           : dv_kernel_info(paged_decode_kernel<PT, HD, GT>, NT, 0, info);
}

template <typename PT, int HD>
int by_group(const DecodeArgs* a, int G, int* info) {
  if (G <= 2) return run<PT, HD, 2>(a, info);
  if (G == 3) return run<PT, HD, 3>(a, info);
  if (G == 4) return run<PT, HD, 4>(a, info);
  return run<PT, HD, 8>(a, info);
}

template <typename PT>
int by_head_dim(const DecodeArgs* a, int HD, int G, int* info) {
  switch (HD) {
    case 32: return by_group<PT, 32>(a, G, info);
    case 64: return by_group<PT, 64>(a, G, info);
    case 128: return by_group<PT, 128>(a, G, info);
    case 256: return by_group<PT, 256>(a, G, info);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int by_pool(int pool_dtype, const DecodeArgs* a, int HD, int G, int* info) {
  if (pool_dtype == DV_BF16)
    return by_head_dim<__nv_bfloat16>(a, HD, G, info);
  if (pool_dtype == DV_I8) return by_head_dim<int8_t>(a, HD, G, info);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// The kernel for HD, pool dtype and GQA group G as the card runs it
// (dv_kernel_info's out[0..4]).
extern "C" int dv_paged_decode_info(int HD, int pool_dtype, int G,
                                    int* out) {
  if (G < 1 || G > MAXG) return static_cast<int>(cudaErrorInvalidValue);
  return by_pool(pool_dtype, nullptr, HD, G, out);
}

// part: B * KV * nsplit * G * (HD + 2) floats of scratch when nsplit > 1
// (null otherwise).
extern "C" int dv_paged_decode_update(
    const void* q, const void* new_k, const void* new_v, void* k_pages,
    void* v_pages, const void* block_tables, const void* seq_lens,
    const void* k_scale, const void* v_scale, void* out, void* part, int B,
    int H, int KV, int N, int P, int MP, int HD, int q_dtype, int pool_dtype,
    int nsplit, float scale, void* stream) {
  if (B <= 0 || KV <= 0 || P <= 0 || MP <= 0 || H % KV != 0 ||
      H / KV > MAXG || q_dtype != DV_BF16 || nsplit < 1 ||
      nsplit > DV_MAX_SPLITS || (nsplit > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const DecodeArgs a{q, new_k, new_v, k_pages, v_pages,
                     static_cast<const int*>(block_tables),
                     static_cast<const int*>(seq_lens),
                     static_cast<const float*>(k_scale),
                     static_cast<const float*>(v_scale), out,
                     static_cast<float*>(part), B, H, KV, N, P, MP, nsplit,
                     scale, static_cast<cudaStream_t>(stream)};
  return by_pool(pool_dtype, &a, HD, H / KV, nullptr);
}
