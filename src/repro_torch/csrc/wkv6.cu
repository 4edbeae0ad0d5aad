// Chunked decayed linear attention (RWKV6 WKV and the SSD scan) for Hopper,
// sm_90a.
//
// Replaces: src/repro/kernels/wkv6/wkv6.py::wkv_pallas (body _wkv_kernel),
// in both of its variants: use_u (RWKV6: bonus u, exclusive decay) and
// use_u=False (SSD: inclusive decay), which
// src/repro/kernels/ssm_scan/ops.py::ssm_scan runs with a per-head decay.
// On the training path it is the forward of the chunked form in
// src/repro/models/linear_attn.py::chunked, which rwkv6._time_mix and
// hybrid._ssm_branch call.  Per (b, h), with a (dk, dv) f32 state S and
// chunks of C steps:
//   cum  = inclusive cumsum of w over the chunk, base = cum - w (use_u) or cum
//   o    = (r * exp(base)) @ S + A @ v
//   A[t,s] = sum_d r[t,d] k[s,d] exp(base[t,d] - cum[s,d])   for s < t
//   A[t,t] = sum_d r[t,d] u[d] k[t,d]   (use_u)   or   sum_d r[t,d] k[t,d]
//   S    = S * exp(cum_last) + (k * exp(cum_last - cum))^T @ v
// Every exponent is of a number <= 0 (w <= 0), and exp is never evaluated
// above the diagonal, where base[t] - cum[s] > 0 could overflow.
//
// Bound on an H100: bytes.  At RWKV6-7B's shape (r/k/v 1x2048x64x64 bf16,
// w f32, o f32) the call moves 118.5 MB (35 us at 3.35 TB/s) and does
// ~5 GFLOP of products (5 us at the bf16 tensor-core rate), but it also
// evaluates C(C-1)/2 * dk exps per chunk and head (~0.54 G at that shape),
// which run on the SFU.  This first version does everything in f32 on the
// CUDA cores out of shared memory, so the pairwise-decay scores (C^2/2 * dk
// multiply-exp-adds per chunk) bound it, far above both; tensor-core tiles
// and a chunk-parallel form (intra-chunk work for all chunks at once, then
// a short scan over chunk states) are later work.
//
// Design: one block of 512 threads owns one (b, h) and one tile of the
// value columns, and walks the chunks in order with S in shared memory:
// nothing carries over between blocks, so the TPU kernel's sequential grid
// becomes a loop inside the block.  There are only B*H heads (64 for
// RWKV6-7B, 25 for Hymba-1.5B) against 132 SMs, so the launch halves the
// value tile (64 at most, 16 at least) while the blocks still fit in one
// wave: 32 columns (128 blocks) for RWKV6, 16 (100 blocks) for Hymba.
// Each tile recomputes the chunk's scores.  Per chunk, r, k and v are read
// as f32 into shared memory (rows padded to an odd stride against bank
// conflicts) and w into rows 1..C of a cumsum buffer whose row 0 is zero;
// one thread per channel turns it into the inclusive cumsum.  So cum[s] is row s+1 and
// base[t] is row t (use_u: cum[t] - w[t] = cum[t-1]) or row t+1.  The C x C
// score matrix A is built with lanes along s (k and cum rows differ per
// lane, r and base rows are broadcast); then r and k are scaled in place
// into r*exp(base) and k*exp(cum_last - cum); then o (lanes along the
// value column) and the state update.  At C = 128, dk = 64 and the widest
// value tile that is 216 KB of shared memory, above the 48 KB default, so
// the launch opts in with cudaFuncSetAttribute (227 KB maximum).  The
// inputs are read in the (B, T, H, d) layout in place (64-bit offsets),
// with no transpose to (B*H, T, d); a per-head decay (last dim 1) is read
// once per (b, t, h).  o is written in f32.  T must be a multiple of C:
// the wrapper pads a ragged T with k = 0 and w = 0.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxDk = 64;
constexpr int kMaxDv = 128;
constexpr int kVTile = 64;     // the widest value tile
constexpr int kMinVTile = 16;  // the narrowest the launch halves it to
constexpr int kMaxChunk = 128;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

struct Layout {
  int ldk, ldv, lda;
  size_t r, k, cum, v, a, s, u, total;  // offsets in floats
};

__host__ __device__ inline Layout layout(int C, int dk, int dvt) {
  Layout L;
  L.ldk = dk + 1;
  L.ldv = dvt + 1;
  L.lda = C + 1;
  L.r = 0;
  L.k = L.r + (size_t)C * L.ldk;
  L.cum = L.k + (size_t)C * L.ldk;
  L.v = L.cum + (size_t)(C + 1) * L.ldk;
  L.a = L.v + (size_t)C * L.ldv;
  L.s = L.a + (size_t)C * L.lda;
  L.u = L.s + (size_t)dk * L.ldv;
  L.total = L.u + dk;
  return L;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ s0,
            float* __restrict__ o, float* __restrict__ sf, int Tn, int H,
            int dk, int dv, int wd, int C, int dvt) {
  extern __shared__ float smem[];
  const Layout L = layout(C, dk, dvt);
  float* sR = smem + L.r;      // [C][ldk]   r, then r * exp(base)
  float* sK = smem + L.k;      // [C][ldk]   k, then k * exp(cum_last - cum)
  float* sCum = smem + L.cum;  // [C+1][ldk] row 0 = 0, row t+1 = cum[t]
  float* sV = smem + L.v;      // [C][ldv]
  float* sA = smem + L.a;      // [C][lda]
  float* sS = smem + L.s;      // [dk][ldv]
  float* sU = smem + L.u;      // [dk]
  const int ldk = L.ldk, ldv = L.ldv, lda = L.lda;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int j0 = blockIdx.y * dvt;
  const int nv = min(dvt, dv - j0);
  const bool use_u = u != nullptr;
  const int boff = use_u ? 0 : 1;    // base[t] is sCum row t + boff
  const int tid = threadIdx.x;
  const long long state0 = ((long long)b * H + h) * dk * dv + j0;

  for (int idx = tid; idx < dk * nv; idx += kThreads) {
    const int d = idx / nv, j = idx - d * nv;
    sS[d * ldv + j] = s0 ? s0[state0 + (long long)d * dv + j] : 0.0f;
  }
  for (int d = tid; d < dk; d += kThreads) {
    sU[d] = use_u ? u[h * dk + d] : 1.0f;
    sCum[d] = 0.0f;
  }

  for (int t0 = 0; t0 < Tn; t0 += C) {
    __syncthreads();  // the previous chunk's readers are done
#pragma unroll 4
    for (int idx = tid; idx < C * dk; idx += kThreads) {
      const int t = idx / dk, d = idx - t * dk;
      const long long row = ((long long)b * Tn + t0 + t) * H + h;
      sR[t * ldk + d] = to_f32(r[row * dk + d]);
      sK[t * ldk + d] = to_f32(k[row * dk + d]);
      sCum[(t + 1) * ldk + d] = w[row * wd + (wd == 1 ? 0 : d)];
    }
#pragma unroll 4
    for (int idx = tid; idx < C * nv; idx += kThreads) {
      const int t = idx / nv, j = idx - t * nv;
      const long long row = ((long long)b * Tn + t0 + t) * H + h;
      sV[t * ldv + j] = to_f32(v[row * dv + j0 + j]);
    }
    __syncthreads();
    for (int d = tid; d < dk; d += kThreads) {   // inclusive cumsum over t
      float acc = 0.0f;
      for (int t = 1; t <= C; ++t) {
        acc += sCum[t * ldk + d];
        sCum[t * ldk + d] = acc;
      }
    }
    __syncthreads();

    // scores: lanes along s; exp only where s < t
    for (int idx = tid; idx < C * C; idx += kThreads) {
      const int t = idx / C, s = idx - t * C;
      const float* rt = sR + t * ldk;
      const float* ks = sK + s * ldk;
      float acc = 0.0f;
      if (s < t) {
        const float* bt = sCum + (t + boff) * ldk;
        const float* cs = sCum + (s + 1) * ldk;
        for (int d = 0; d < dk; ++d)
          acc += rt[d] * ks[d] * expf(bt[d] - cs[d]);
      } else if (s == t) {
        for (int d = 0; d < dk; ++d) acc += rt[d] * sU[d] * ks[d];
      }
      sA[t * lda + s] = acc;
    }
    __syncthreads();

    const float* cum_last = sCum + C * ldk;
    for (int idx = tid; idx < C * dk; idx += kThreads) {
      const int t = idx / dk, d = idx - t * dk;
      sR[t * ldk + d] *= expf(sCum[(t + boff) * ldk + d]);
      sK[t * ldk + d] *= expf(cum_last[d] - sCum[(t + 1) * ldk + d]);
    }
    __syncthreads();

    // o = (r * exp(base)) @ S + A @ v, lanes along the value column
    for (int idx = tid; idx < C * nv; idx += kThreads) {
      const int t = idx / nv, j = idx - t * nv;
      const float* qt = sR + t * ldk;
      const float* at = sA + t * lda;
      float acc = 0.0f;
      for (int d = 0; d < dk; ++d) acc += qt[d] * sS[d * ldv + j];
      for (int s = 0; s <= t; ++s) acc += at[s] * sV[s * ldv + j];
      const long long row = ((long long)b * Tn + t0 + t) * H + h;
      o[row * dv + j0 + j] = acc;
    }
    __syncthreads();

    // S = S * exp(cum_last) + (k * exp(cum_last - cum))^T @ v
    for (int idx = tid; idx < dk * nv; idx += kThreads) {
      const int d = idx / nv, j = idx - d * nv;
      float acc = sS[d * ldv + j] * expf(cum_last[d]);
      for (int s = 0; s < C; ++s) acc += sK[s * ldk + d] * sV[s * ldv + j];
      sS[d * ldv + j] = acc;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < dk * nv; idx += kThreads) {
    const int d = idx / nv, j = idx - d * nv;
    sf[state0 + (long long)d * dv + j] = sS[d * ldv + j];
  }
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* s0, void* o, void* sf, int B, int Tn,
           int H, int dk, int dv, int wd, int C, void* stream) {
  if (B < 1 || H < 1 || Tn < 1 || C < 1 || C > kMaxChunk || Tn % C != 0 ||
      dk < 1 || dk > kMaxDk || dv < 1 || dv > kMaxDv ||
      (wd != 1 && wd != dk) || (long long)B * H > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  int dvt = dv < kVTile ? dv : kVTile;
  while (dvt > kMinVTile &&
         (long long)B * H * ((dv + dvt / 2 - 1) / (dvt / 2)) <= sms)
    dvt /= 2;
  const size_t smem = sizeof(float) * layout(C, dk, dvt).total;
  err = cudaFuncSetAttribute(
      wkv6_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)(B * H), (unsigned)((dv + dvt - 1) / dvt));
  wkv6_kernel<T><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)r, (const T*)k, (const T*)v, (const float*)w,
      (const float*)u, (const float*)s0, (float*)o, (float*)sf, Tn, H, dk,
      dv, wd, C, dvt);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// r/k: (B, T, H, dk), v: (B, T, H, dv), w: (B, T, H, wd) f32 with wd 1 or
// dk, u: (H, dk) f32 or null (SSD), s0: (B, H, dk, dv) f32 or null (zero),
// o: (B, T, H, dv) f32, sf: (B, H, dk, dv) f32; all contiguous on the
// device, T % C == 0.
int wkv6_bf16(const void* r, const void* k, const void* v, const void* w,
              const void* u, const void* s0, void* o, void* sf, int B, int T,
              int H, int dk, int dv, int wd, int C, void* stream) {
  return launch<__nv_bfloat16>(r, k, v, w, u, s0, o, sf, B, T, H, dk, dv, wd,
                               C, stream);
}

int wkv6_f32(const void* r, const void* k, const void* v, const void* w,
             const void* u, const void* s0, void* o, void* sf, int B, int T,
             int H, int dk, int dv, int wd, int C, void* stream) {
  return launch<float>(r, k, v, w, u, s0, o, sf, B, T, H, dk, dv, wd, C,
                       stream);
}

}  // extern "C"
