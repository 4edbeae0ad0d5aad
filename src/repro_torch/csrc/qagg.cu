// Fused int8 dequantize + weighted sum over clients (qagg) for Hopper, sm_90a.
//
// Replaces: src/repro/kernels/fedavg/fedavg.py::qagg_pallas (body
// _qagg_kernel), the TPU kernel of the ``compressed`` aggregation schedule.
// It reads K clients' int8 payloads q (K, R, G) with one f32 scale per
// (client, row), s (K, R), and client weights w (K,), and writes the f32
// sum over k of (q[k] * s[k]) * w[k]: (R, G).  G is the leaf's last dim.
//
// Bound on an H100: memory.  Per output element it reads K bytes of q and
// writes 4 bytes, with 3K flops: under one flop per byte.  At the round's
// largest leaf, q (4, 152064, 3584), that is 2.18 GB read plus 2.18 GB
// written (and 2.4 MB of scales), 1.30 ms at 3.35 TB/s.
//
// Design: one pass, nothing materialized in f32 but the output.  When G is
// a multiple of 16 and the pointers are 16-byte aligned, each thread owns
// 16 contiguous elements of one row (one 16-byte load per client, four
// 16-byte stores); otherwise each thread owns one element.  A grid-stride loop
// covers any R * G; offsets are 64-bit (the embed leaf's payload has
// 2.18 G elements).  A thread reads its row's K scales once per chunk; the
// threads of a warp share a row, so those loads are broadcasts from L1.
// The sum runs k = 0..K-1 in that fixed order with __fmul_rn / __fadd_rn
// (no FMA contraction), starting from +0, so the plain PyTorch version
// that sums in the same order agrees bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxClients = 256;
constexpr int kThreads = 256;
constexpr int kVec = 16;

__device__ __forceinline__ float term(int8_t q, float s, float w) {
  return __fmul_rn(__fmul_rn((float)q, s), w);
}

__global__ void __launch_bounds__(kThreads)
qagg_vec_kernel(const int8_t* __restrict__ q, const float* __restrict__ s,
                const float* __restrict__ w, float* __restrict__ out, int K,
                long long R, long long G) {
  __shared__ float sw[kMaxClients];
  for (int k = threadIdx.x; k < K; k += blockDim.x) sw[k] = w[k];
  __syncthreads();
  const long long per_row = G / kVec;
  const long long chunks = R * per_row;
  const long long RG = R * G;
  for (long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       c < chunks; c += (long long)gridDim.x * blockDim.x) {
    const long long row = c / per_row;
    const long long off = row * G + (c - row * per_row) * kVec;
    float acc[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) acc[j] = 0.0f;
    for (int k = 0; k < K; ++k) {
      const uint4 raw = *reinterpret_cast<const uint4*>(q + (long long)k * RG + off);
      const int8_t* v = reinterpret_cast<const int8_t*>(&raw);
      const float sk = s[(long long)k * R + row];
      const float wk = sw[k];
#pragma unroll
      for (int j = 0; j < kVec; ++j) acc[j] = __fadd_rn(acc[j], term(v[j], sk, wk));
    }
    float4* o = reinterpret_cast<float4*>(out + off);
#pragma unroll
    for (int j = 0; j < kVec / 4; ++j)
      o[j] = make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]);
  }
}

__global__ void __launch_bounds__(kThreads)
qagg_scalar_kernel(const int8_t* __restrict__ q, const float* __restrict__ s,
                   const float* __restrict__ w, float* __restrict__ out, int K,
                   long long R, long long G) {
  __shared__ float sw[kMaxClients];
  for (int k = threadIdx.x; k < K; k += blockDim.x) sw[k] = w[k];
  __syncthreads();
  const long long RG = R * G;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < RG;
       i += (long long)gridDim.x * blockDim.x) {
    const long long row = i / G;
    float acc = 0.0f;
    for (int k = 0; k < K; ++k)
      acc = __fadd_rn(acc, term(q[(long long)k * RG + i], s[(long long)k * R + row], sw[k]));
    out[i] = acc;
  }
}

}  // namespace

extern "C" {

// q: (K, R, G) int8, s: (K, R) f32, w: (K,) f32, out: (R, G) f32; all
// row-major on the device.  Returns cudaGetLastError() after the launch.
int qagg(const void* q, const void* s, const void* w, void* out, int K,
         long long R, long long G, void* stream) {
  if (K < 1 || K > kMaxClients || R < 1 || G < 1) return (int)cudaErrorInvalidValue;
  const bool vec = (G % kVec == 0) && ((uintptr_t)q % 16 == 0) &&
                   ((uintptr_t)out % 16 == 0);
  const long long work = vec ? R * (G / kVec) : R * G;
  long long blocks = (work + kThreads - 1) / kThreads;
  const long long max_blocks = 132LL * 16;  // 16 resident blocks per SM
  if (blocks > max_blocks) blocks = max_blocks;
  cudaStream_t st = (cudaStream_t)stream;
  if (vec)
    qagg_vec_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(
        (const int8_t*)q, (const float*)s, (const float*)w, (float*)out, K, R, G);
  else
    qagg_scalar_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(
        (const int8_t*)q, (const float*)s, (const float*)w, (float*)out, K, R, G);
  return (int)cudaGetLastError();
}

}  // extern "C"
