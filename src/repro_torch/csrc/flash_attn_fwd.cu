// Flash-attention forward (online softmax) for Hopper, sm_90a.
//
// Replaces: src/repro/kernels/flash_attn/flash_attn.py::flash_fwd_pallas
// (body _flash_kernel), and on the training path the forward of
// src/repro/models/attention.py::_flash_impl.  Causal and sliding-window
// attention with GQA; running max / sum / accumulator in f32; masked scores
// are NEG_INF = -1e30 as in the reference.  Besides o it writes the row
// log-sum-exp, which the backward recomputes the probabilities from.
//
// Bound on an H100: operations.  At the round's shape (q 1x2048x28x128,
// k/v 1x2048x4x128, causal) the work is ~30 GFLOP against ~25 MB of
// inputs and outputs, so the bf16 tensor-core roofline is ~30 us.  This
// first version does its products in f32 on the CUDA cores (67 TFLOP/s
// peak, about a quarter of that reachable from shared memory), so it is
// far from that bound; mma.sync / wgmma tiles are later work.
//
// Design: one block of 256 threads per (batch, head, 64-row q tile).  The
// kv head is h / (H / Kv): GQA reads k and v in place, nothing is repeated
// in memory.  The q tile and one 32-row k/v tile live in shared memory as
// f32 (rows padded to hd+1 floats so neither the row-per-thread q reads nor
// the column-per-thread k reads hit one bank).  Four threads share a q row:
// each scores 8 of the 32 keys, the row max and sum are combined with warp
// shuffles, and each owns hd/4 output dims (d = quarter + 4i) of the f32
// accumulator in registers.  The mask is derived from positions
// (q_offset + row, kv_offset + col); k/v tiles that lie wholly beyond the
// causal diagonal end the loop and tiles wholly before the window are
// skipped.  Offsets into q/k/v/o are 64-bit.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kBQ = 64;       // q rows per block
constexpr int kBK = 32;       // keys per k/v tile
constexpr int kThreads = 256; // 4 threads per q row
constexpr int kMaxHd = 128;
constexpr int kDimsPerThread = kMaxHd / 4;
constexpr int kColsPerThread = kBK / 4;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int Sq, int Sk, int H, int Kv,
                 int hd, int causal, int window, int q_offset, int kv_offset,
                 float scale) {
  extern __shared__ float smem[];
  const int ld = hd + 1;
  float* sQ = smem;                  // [kBQ][ld]
  float* sK = sQ + kBQ * ld;         // [kBK][ld]
  float* sV = sK + kBK * ld;         // [kBK][ld]
  float* sP = sV + kBK * ld;         // [kBQ][kBK + 1]
  const int ldp = kBK + 1;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / Kv);
  const int q0 = blockIdx.y * kBQ;
  const int tid = threadIdx.x;
  const int r = tid >> 2, quarter = tid & 3;
  const int nrows = min(kBQ, Sq - q0);
  const bool row_ok = r < nrows;
  const int my_qpos = q_offset + q0 + r;
  const int qpos_lo = q_offset + q0, qpos_hi = q_offset + q0 + nrows - 1;

  for (int idx = tid; idx < kBQ * hd; idx += kThreads) {
    const int rr = idx / hd, d = idx - rr * hd;
    const int s = q0 + rr;
    sQ[rr * ld + d] = s < Sq
        ? to_f32(q[(((long long)b * Sq + s) * H + h) * hd + d]) : 0.0f;
  }

  float m = kNegInf, l = 0.0f;
  float acc[kDimsPerThread];
#pragma unroll
  for (int i = 0; i < kDimsPerThread; ++i) acc[i] = 0.0f;

  for (int k0 = 0; k0 < Sk; k0 += kBK) {
    const int ncols = min(kBK, Sk - k0);
    const int kpos_lo = kv_offset + k0, kpos_hi = kpos_lo + ncols - 1;
    if (causal && kpos_lo > qpos_hi) break;               // beyond the diagonal
    if (window > 0 && qpos_lo - kpos_hi >= window) continue;  // before the window

    __syncthreads();  // the previous tile's readers are done with sK/sV/sP
    for (int idx = tid; idx < kBK * hd; idx += kThreads) {
      const int c = idx / hd, d = idx - c * hd;
      const int s = k0 + c;
      const long long off = (((long long)b * Sk + s) * Kv + kvh) * hd + d;
      const bool in = s < Sk;
      sK[c * ld + d] = in ? to_f32(k[off]) : 0.0f;
      sV[c * ld + d] = in ? to_f32(v[off]) : 0.0f;
    }
    __syncthreads();

    float sc[kColsPerThread];
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) sc[j] = 0.0f;
    const float* qrow = sQ + r * ld;
    for (int d = 0; d < hd; ++d) {
      const float qv = qrow[d];
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j)
        sc[j] += qv * sK[(j * 4 + quarter) * ld + d];
    }

    bool ok[kColsPerThread];
    float tmax = kNegInf;
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      const int c = j * 4 + quarter;
      const int kp = kpos_lo + c;
      ok[j] = row_ok && c < ncols && (!causal || my_qpos >= kp) &&
              (window <= 0 || my_qpos - kp < window);
      sc[j] = ok[j] ? sc[j] * scale : kNegInf;
      tmax = fmaxf(tmax, sc[j]);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float m_new = fmaxf(m, tmax);
    const float alpha = expf(m - m_new);

    float psum = 0.0f;
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      const float p = ok[j] ? expf(sc[j] - m_new) : 0.0f;
      sP[r * ldp + j * 4 + quarter] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * alpha + psum;
    m = m_new;
    __syncwarp();  // the row's four threads read each other's sP entries

#pragma unroll
    for (int i = 0; i < kDimsPerThread; ++i) acc[i] *= alpha;
    const float* prow = sP + r * ldp;
    for (int c = 0; c < ncols; ++c) {
      const float p = prow[c];
      const float* vrow = sV + c * ld + quarter;
#pragma unroll
      for (int i = 0; i < kDimsPerThread; ++i)
        if (quarter + 4 * i < hd) acc[i] += p * vrow[4 * i];
    }
  }

  if (row_ok) {
    const float denom = fmaxf(l, 1e-30f);
    const long long base = (((long long)b * Sq + q0 + r) * H + h) * hd;
#pragma unroll
    for (int i = 0; i < kDimsPerThread; ++i) {
      const int d = quarter + 4 * i;
      if (d < hd) store(o + base + d, acc[i] / denom);
    }
    if (quarter == 0)
      lse[((long long)b * H + h) * Sq + q0 + r] = m + logf(denom);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int Sq, int Sk, int H, int Kv, int hd, int causal,
           int window, int q_offset, int kv_offset, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || Kv < 1 || H % Kv != 0 || hd < 1 ||
      hd > kMaxHd)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) *
      ((size_t)(kBQ + 2 * kBK) * (hd + 1) + (size_t)kBQ * (kBK + 1));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)(B * H), (unsigned)((Sq + kBQ - 1) / kBQ));
  const float scale = 1.0f / sqrtf((float)hd);
  flash_fwd_kernel<T><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, (float*)lse, Sq, Sk, H,
      Kv, hd, causal, window, q_offset, kv_offset, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q: (B, Sq, H, hd), k/v: (B, Sk, Kv, hd), o: like q, lse: (B, H, Sq) f32;
// all contiguous on the device.  window <= 0 means no window.
int flash_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                   void* lse, int B, int Sq, int Sk, int H, int Kv, int hd,
                   int causal, int window, int q_offset, int kv_offset,
                   void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, lse, B, Sq, Sk, H, Kv, hd, causal,
                               window, q_offset, kv_offset, stream);
}

int flash_fwd_f32(const void* q, const void* k, const void* v, void* o,
                  void* lse, int B, int Sq, int Sk, int H, int Kv, int hd,
                  int causal, int window, int q_offset, int kv_offset,
                  void* stream) {
  return launch<float>(q, k, v, o, lse, B, Sq, Sk, H, Kv, hd, causal, window,
                       q_offset, kv_offset, stream);
}

}  // extern "C"
