// Exact split of a float32 matrix into three bf16 terms: w = hi + mid + lo.
//
// Replaces no TPU kernel: the JAX package leaves its float32 matmuls to
// XLA.  The port runs them as sums of bf16 tensor-core GEMMs with float32
// accumulators (engine/f32_matmul.py), and this pass makes their float32
// operands' terms:
//
//   hi  = bf16(w)            (round to nearest even)
//   mid = bf16(w - hi)       (w - hi is exact in float32)
//   lo  = bf16(w - hi - mid)
//
// For every finite w with |w| >= 2^-110 the three terms add up to w bit
// for bit; below that lo's lowest bit is under bf16's smallest subnormal
// (2^-133), and the sum misses w by at most 2^-134.  A finite w that
// rounds to a bf16 infinity takes hi = +-bf16 max, so mid and lo carry the
// rest; a non-finite w keeps it in hi, with mid = lo = 0; a zero gives
// three zeros of its sign.  No flag here flushes subnormals, so they split
// as the plain version splits them.
//
//   in [R, C] float32, contiguous; value (r, c)'s terms go to
//   out[t * term_stride + r * row_stride + c] (bf16), t = 0, 1, 2 for lo,
//   mid, hi: smallest first, the order in which a product adds them up.
//   term_stride R * C and row_stride C stack the terms along the rows
//   ([3R, C]), term_stride C and row_stride 3C along the columns ([R, 3C]).
//   A second output (out2, null for none) takes the same terms in a
//   layout of its own: a weight's forward product wants them stacked one
//   way and its backward the other.
//
// Bound on this card: HBM bytes, 4 read and 6 written a value, 12 with a
// second layout (dv-base's training step splits 1 GiB of float32 logit
// gradients: 2.7 GB, 0.8 ms at 3.35 TB/s).  The arithmetic is a few
// instructions a value.
//
// Design: a block of 256 threads takes one row at a time (blockIdx.y,
// striding by gridDim.y) and a 16-byte float4 a thread across it
// (blockIdx.x, striding by the grid's width), so no thread divides by C;
// each term goes out as one 8-byte store.  Where C, the strides or the
// pointers do not allow that, the same loop runs a value a thread.

#include "common.cuh"

namespace {

// t[0..2] = lo, mid, hi of w
__device__ __forceinline__ void split3(float w, __nv_bfloat16* t) {
  __nv_bfloat16 hi = __float2bfloat16_rn(w);
  float hf = __bfloat162float(hi);
  const bool finite = isfinite(w);
  if (finite && isinf(hf)) {
    hi = __ushort_as_bfloat16(signbit(w) ? 0xFF7Fu : 0x7F7Fu);
    hf = __bfloat162float(hi);
  }
  // a zero's residuals are zeros of its sign, so -0 rebuilds as -0
  const float r = w == 0.0f ? w : finite ? w - hf : 0.0f;
  const __nv_bfloat16 mid = __float2bfloat16_rn(r);
  t[2] = hi;
  t[1] = mid;
  t[0] = w == 0.0f ? hi : __float2bfloat16_rn(r - __bfloat162float(mid));
}

template <int VEC>
__global__ void __launch_bounds__(256)
bf16_split_kernel(const float* __restrict__ in, __nv_bfloat16* __restrict__ out,
                  __nv_bfloat16* __restrict__ out2, long long R, long long C,
                  long long term_stride, long long row_stride,
                  long long term_stride2, long long row_stride2) {
  const long long chunks = C / VEC;
  for (long long r = blockIdx.y; r < R; r += gridDim.y) {
    const float* row = in + r * C;
    __nv_bfloat16* dst = out + r * row_stride;
    __nv_bfloat16* dst2 = out2 ? out2 + r * row_stride2 : nullptr;
    for (long long k = blockIdx.x * (long long)blockDim.x + threadIdx.x;
         k < chunks; k += (long long)gridDim.x * blockDim.x) {
      if constexpr (VEC == 4) {
        const float4 v = reinterpret_cast<const float4*>(row)[k];
        __nv_bfloat16 t0[3], t1[3], t2[3], t3[3];
        split3(v.x, t0);
        split3(v.y, t1);
        split3(v.z, t2);
        split3(v.w, t3);
#pragma unroll
        for (int t = 0; t < 3; ++t) {
          __align__(8) __nv_bfloat16 q[4] = {t0[t], t1[t], t2[t], t3[t]};
          const uint2 packed = *reinterpret_cast<const uint2*>(q);
          *reinterpret_cast<uint2*>(dst + t * term_stride + 4 * k) = packed;
          if (dst2)
            *reinterpret_cast<uint2*>(dst2 + t * term_stride2 + 4 * k) =
                packed;
        }
      } else {
        __nv_bfloat16 t3[3];
        split3(row[k], t3);
#pragma unroll
        for (int t = 0; t < 3; ++t) {
          dst[t * term_stride + k] = t3[t];
          if (dst2) dst2[t * term_stride2 + k] = t3[t];
        }
      }
    }
  }
}

}  // namespace

extern "C" int dv_bf16_split(const void* in, void* out, void* out2,
                             long long R, long long C, long long term_stride,
                             long long row_stride, long long term_stride2,
                             long long row_stride2, void* stream) {
  if (R <= 0 || C <= 0) return 0;
  const bool vec = C % 4 == 0 && term_stride % 4 == 0 &&
                   row_stride % 4 == 0 && term_stride2 % 4 == 0 &&
                   row_stride2 % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(in) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(out2) % 8 == 0;
  const long long chunks = vec ? C / 4 : C;
  const int threads = 256;
  long long gx = (chunks + threads - 1) / threads;
  if (gx > 1024) gx = 1024;
  long long gy = R < 65535 ? R : 65535;
  // at most about four waves of 8 blocks on each of the 132 SMs; each
  // block then takes several rows
  while (gy > 1 && gx * gy > 132LL * 8 * 4) gy = (gy + 1) / 2;
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec)
    bf16_split_kernel<4><<<grid, threads, 0, s>>>(
        static_cast<const float*>(in), static_cast<__nv_bfloat16*>(out),
        static_cast<__nv_bfloat16*>(out2), R, C, term_stride, row_stride,
        term_stride2, row_stride2);
  else
    bf16_split_kernel<1><<<grid, threads, 0, s>>>(
        static_cast<const float*>(in), static_cast<__nv_bfloat16*>(out),
        static_cast<__nv_bfloat16*>(out2), R, C, term_stride, row_stride,
        term_stride2, row_stride2);
  return static_cast<int>(cudaGetLastError());
}
