// Weighted K-way parameter mean (FedAvg) for Hopper, sm_90a.
//
// Replaces: src/repro/kernels/fedavg/fedavg.py::fedavg_pallas (body
// _fedavg_kernel), the TPU kernel that reduces K client parameter blocks
// (K, N) into their weighted mean (N,), accumulating in f32.
//
// Bound on an H100: memory.  The kernel reads K*N elements and writes N,
// with 2K+2 flops per output element (K mul-adds, one divide): about one
// flop per byte, far below the ~295 flop/byte ridge.  At the round's
// largest leaf, (4, 152064*3584) bf16, that is 5.45 GB, 1.6 ms at 3.35 TB/s.
//
// Design: one pass over the inputs, nothing materialized in f32.  Each
// thread owns 8 contiguous elements (one 16-byte load per client row for
// bf16, two for f32), walks k = 0..K-1 in that fixed order with separate
// f32 multiply and add (no FMA contraction, so the plain PyTorch version
// that sums in the same order agrees bit for bit), divides by the weight
// total summed in the same order, and stores in the input dtype with
// round-to-nearest-even.  A grid-stride loop covers any N; a ragged tail,
// or rows that are not 16-byte aligned, take the scalar path, so N needs
// no padding.  Offsets are 64-bit: a (4, 545M) leaf has 2.2G elements.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kMaxClients = 256;
constexpr int kThreads = 256;
constexpr int kVec = 8;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f32(float v, float* dst) { *dst = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* dst) { *dst = __float2bfloat16_rn(v); }

template <typename T>
__device__ __forceinline__ void load8(const T* p, float* out);

template <>
__device__ __forceinline__ void load8<__nv_bfloat16>(const __nv_bfloat16* p, float* out) {
  uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = __bfloat162float(h[i]);
}

template <>
__device__ __forceinline__ void load8<float>(const float* p, float* out) {
  float4 a = *reinterpret_cast<const float4*>(p);
  float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

template <typename T>
__device__ __forceinline__ void store8(T* p, const float* v);

template <>
__device__ __forceinline__ void store8<__nv_bfloat16>(__nv_bfloat16* p, const float* v) {
  uint4 raw;
  __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) h[i] = __float2bfloat16_rn(v[i]);
  *reinterpret_cast<uint4*>(p) = raw;
}

template <>
__device__ __forceinline__ void store8<float>(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fedavg_kernel(const T* __restrict__ x, const float* __restrict__ w,
              T* __restrict__ out, int K, long long N, int vec_ok) {
  __shared__ float sw[kMaxClients];
  __shared__ float s_total;
  for (int k = threadIdx.x; k < K; k += blockDim.x) sw[k] = w[k];
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.0f;
    for (int k = 0; k < K; ++k) t = __fadd_rn(t, sw[k]);
    s_total = t;
  }
  __syncthreads();
  const float total = s_total;

  const long long stride = (long long)gridDim.x * blockDim.x * kVec;
  for (long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * kVec;
       i < N; i += stride) {
    float acc[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) acc[j] = 0.0f;
    if (vec_ok && i + kVec <= N) {
      for (int k = 0; k < K; ++k) {
        float v[kVec];
        load8<T>(x + (long long)k * N + i, v);
        const float wk = sw[k];
#pragma unroll
        for (int j = 0; j < kVec; ++j) acc[j] = __fadd_rn(acc[j], __fmul_rn(v[j], wk));
      }
      float o[kVec];
#pragma unroll
      for (int j = 0; j < kVec; ++j) o[j] = __fdiv_rn(acc[j], total);
      store8<T>(out + i, o);
    } else {
      const int n = (int)((N - i) < kVec ? (N - i) : kVec);
      for (int k = 0; k < K; ++k) {
        const float wk = sw[k];
        const T* row = x + (long long)k * N + i;
        for (int j = 0; j < n; ++j) acc[j] = __fadd_rn(acc[j], __fmul_rn(to_f32(row[j]), wk));
      }
      for (int j = 0; j < n; ++j) from_f32(__fdiv_rn(acc[j], total), out + i + j);
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, void* out, int K, long long N,
           void* stream) {
  if (K < 1 || K > kMaxClients || N < 1) return (int)cudaErrorInvalidValue;
  const int vec_ok = (N % kVec == 0) &&
                     ((uintptr_t)x % 16 == 0) && ((uintptr_t)out % 16 == 0);
  long long chunks = (N + kVec - 1) / kVec;
  long long blocks = (chunks + kThreads - 1) / kThreads;
  const long long max_blocks = 132LL * 16;  // 16 resident blocks per SM
  if (blocks > max_blocks) blocks = max_blocks;
  fedavg_kernel<T><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)x, (const float*)w, (T*)out, K, N, vec_ok);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x: (K, N) row-major, w: (K,) f32, out: (N,); all on the device.
int fedavg_bf16(const void* x, const void* w, void* out, int K, long long N,
                void* stream) {
  return launch<__nv_bfloat16>(x, w, out, K, N, stream);
}

int fedavg_f32(const void* x, const void* w, void* out, int K, long long N,
               void* stream) {
  return launch<float>(x, w, out, K, N, stream);
}

}  // extern "C"
