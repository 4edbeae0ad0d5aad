// Symmetric int8 quantize / dequantize per 256-element block (quant8) for
// Hopper, sm_90a.
//
// Replaces: src/repro/kernels/quant8/quant8.py::quantize_pallas (body
// _quant_kernel) and ::dequantize_pallas (body _dequant_kernel).  Quantize
// reads x (R, 256) bf16 or f32 and writes q (R, 256) int8 and one scale per
// row, scale = max(amax / 127, 1e-12), q = clip(rint(x / scale), -127, 127),
// where amax / 127 is amax * f32(1/127): XLA compiles the reference's
// division by the constant 127 as that multiply, and the port matches it.
// Dequantize writes q * scale[row] in f32.
//
// Bound on an H100: memory.  Quantize moves N * sizeof(x) + N + 4N/256
// bytes with a few flops per element; dequantize N + 4N/256 + 4N bytes with
// one multiply per element.  At N = 545 M (the embed table of qwen2-7b),
// bf16 quantize moves 1.64 GB (0.49 ms at 3.35 TB/s) and dequantize 2.73 GB
// (0.82 ms).
//
// Design: one warp per 256-element row, eight rows per block, a
// grid-stride loop over rows.  Each lane loads 8 contiguous elements (one
// 16-byte load for bf16, two for f32), the warp reduces the row's amax with
// shuffles, lane 0 writes the scale, and each lane writes its 8 int8 values
// as one 8-byte store.  x / scale is an IEEE division (__fdiv_rn, never a
// multiply by the reciprocal) and rintf rounds half to even, as the plain
// version does.  NaN: a row holding a NaN gets a NaN scale (the max here
// keeps NaN, as torch.amax and jnp.max do; fmaxf would drop it), and every value
// that is NaN after the division (a NaN input, or any value of a row whose
// scale is NaN or infinite) is written as q = 0, the value XLA's and the
// plain version's float-to-int8 conversion gives NaN.  Dequantize takes 4
// int8 values per thread (one 4-byte load, one 16-byte store), so a warp
// reads 128 and writes 512 contiguous bytes.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;      // elements per scale
constexpr int kThreads = 256;    // 8 warps: 8 rows per block
constexpr int kRowsPerBlock = kThreads / 32;
constexpr float kInv127 = 1.0f / 127.0f;  // correctly rounded at compile time

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = __bfloat162float(h[i]);
}

__device__ __forceinline__ void load8(const float* p, float* out) {
  float4 a = *reinterpret_cast<const float4*>(p);
  float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

// max that keeps NaN (fmaxf returns the other operand)
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
quantize_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                float* __restrict__ scales, long long R) {
  const int lane = threadIdx.x & 31;
  for (long long row = (long long)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
       row < R; row += (long long)gridDim.x * kRowsPerBlock) {
    const long long off = row * kBlock + lane * 8;
    float v[8];
    load8(x + off, v);
    float amax = fabsf(v[0]);
#pragma unroll
    for (int i = 1; i < 8; ++i) amax = nan_max(fabsf(v[i]), amax);
#pragma unroll
    for (int d = 16; d > 0; d >>= 1)
      amax = nan_max(__shfl_xor_sync(0xffffffffu, amax, d), amax);
    float scale = __fmul_rn(amax, kInv127);
    scale = (scale != scale) ? scale : fmaxf(scale, 1e-12f);
    uint2 packed;
    int8_t* out = reinterpret_cast<int8_t*>(&packed);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float r = rintf(__fdiv_rn(v[i], scale));
      out[i] = (r != r) ? (int8_t)0 : (int8_t)fminf(fmaxf(r, -127.0f), 127.0f);
    }
    *reinterpret_cast<uint2*>(q + off) = packed;
    if (lane == 0) scales[row] = scale;
  }
}

__global__ void __launch_bounds__(kThreads)
dequantize_kernel(const int8_t* __restrict__ q, const float* __restrict__ scales,
                  float* __restrict__ out, long long R) {
  const long long chunks = R * (kBlock / 4);
  for (long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       c < chunks; c += (long long)gridDim.x * blockDim.x) {
    const long long off = c * 4;
    const float s = scales[off / kBlock];
    const char4 v = *reinterpret_cast<const char4*>(q + off);
    *reinterpret_cast<float4*>(out + off) =
        make_float4(__fmul_rn((float)v.x, s), __fmul_rn((float)v.y, s),
                    __fmul_rn((float)v.z, s), __fmul_rn((float)v.w, s));
  }
}

long long grid_for(long long work, long long per_block) {
  long long blocks = (work + per_block - 1) / per_block;
  const long long max_blocks = 132LL * 16;  // 16 resident blocks per SM
  return blocks > max_blocks ? max_blocks : blocks;
}

template <typename T>
int quantize(const void* x, void* q, void* scales, long long R, void* stream) {
  if (R < 1 || (uintptr_t)x % 16 || (uintptr_t)q % 16) return (int)cudaErrorInvalidValue;
  quantize_kernel<T><<<(unsigned)grid_for(R, kRowsPerBlock), kThreads, 0,
                       (cudaStream_t)stream>>>((const T*)x, (int8_t*)q, (float*)scales, R);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x: (R, 256) bf16 or f32, q: (R, 256) int8, scales: (R,) f32; row-major
// on the device.  Each returns cudaGetLastError() after its launch.
int quant8_quantize_bf16(const void* x, void* q, void* scales, long long R,
                         void* stream) {
  return quantize<__nv_bfloat16>(x, q, scales, R, stream);
}

int quant8_quantize_f32(const void* x, void* q, void* scales, long long R,
                        void* stream) {
  return quantize<float>(x, q, scales, R, stream);
}

// q: (R, 256) int8, scales: (R,) f32, out: (R, 256) f32.
int quant8_dequantize(const void* q, const void* scales, void* out, long long R,
                      void* stream) {
  if (R < 1 || (uintptr_t)q % 16 || (uintptr_t)out % 16) return (int)cudaErrorInvalidValue;
  dequantize_kernel<<<(unsigned)grid_for(R * (kBlock / 4), kThreads), kThreads, 0,
                      (cudaStream_t)stream>>>((const int8_t*)q, (const float*)scales,
                                              (float*)out, R);
  return (int)cudaGetLastError();
}

}  // extern "C"
