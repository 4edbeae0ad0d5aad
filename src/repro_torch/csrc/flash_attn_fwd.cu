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
// inputs and outputs: ~30 us at the bf16 tensor-core rate, ~8 us of bytes.
// So the bf16 entry does both products on the tensor cores.
//
// bf16 entry (flash_fwd_bf16), FlashAttention-2 style:
// - One block per (b, q head, q tile) of 128 rows (8 warps) at hd 128, or
//   of 64 rows (4 warps) at smaller head dims or when 128-row tiles would
//   not fill one wave of SMs.  Each warp owns 16 q rows.  The q tiles of
//   the diagonal's far end, which have the most keys, are scheduled first.
// - The q tile is read once (cp.async) and held in registers as bf16
//   A-fragments (ldmatrix) for the whole kv loop.
// - K/V tiles of 64 keys x hd go through a two-stage ring in shared memory,
//   filled with cp.async: tile i+1 is in flight while tile i is computed,
//   with one barrier a tile.
//   Rows are padded by 16 bytes so that ldmatrix's eight row reads fall in
//   eight different bank groups.  The head dim is zero-padded in shared
//   memory to an instantiated width (16/32/64/128).
// - S = Q K^T and O += P V are mma.sync.m16n8k16 bf16 products with f32
//   accumulators; K is read with ldmatrix, V with ldmatrix.trans.
// - The online softmax works on the accumulator fragments: a row's max and
//   sum are combined over the quad of lanes that holds it with shuffles,
//   and exp2f takes scores pre-multiplied by scale * log2(e).  The row sum
//   is kept per lane and reduced once at the end.
// - P is rounded to bf16 A-fragments in registers (the S accumulator's
//   layout is the A operand's), never written to shared memory; the row
//   sum uses the unrounded f32 P, as the reference's bf16 path does.
// - Tiles wholly past the causal diagonal or before the window are never
//   loaded (the first window tile is computed from the positions); the mask
//   is applied only on tiles that cut the diagonal, the window edge or the
//   end of the keys, and a warp whose 16 rows see none of a tile's keys
//   skips its products.
// - GQA reads kv head h / (H / Kv) in place; offsets are 64-bit.  When hd
//   is not a multiple of 8 (or a pointer is not 16-byte aligned) tiles are
//   loaded with plain loads instead of cp.async.
//
// f32 entry (flash_fwd_f32): on no path (the models' parameters are bf16).
// It keeps the first form's f32 CUDA-core body, so that its results stay
// within f32 summation order of the plain version: one 256-thread block per
// (b, h, 64-row q tile), 32-key tiles as f32 in shared memory, four threads
// a q row.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxHd = 128;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// --------------------------------------------------------------------------
// bf16: tensor cores
// --------------------------------------------------------------------------

constexpr int kBK = 64;  // keys per K/V tile
// K/V tiles in the shared-memory ring (measured on an H100: 3 or 4 stages
// are no faster at hd 128 and slower at hd 64, where they cost blocks)
constexpr int kStages = 2;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a (16x16, row) @ b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> bf16x2, the first in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Copy `rows` rows of a (.., S, heads, hd) tensor, starting at `src` (row
// stride `stride` elements), into shared memory rows of LD elements, zero
// beyond `valid` rows and beyond hd columns up to HD.
template <int HD, int LD>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          const bf16* any, long long stride,
                                          int rows, int valid, int hd,
                                          bool vec, int tid, int nthreads) {
  if (vec) {
    constexpr int kChunks = HD / 8;
    for (int idx = tid; idx < rows * kChunks; idx += nthreads) {
      const int r = idx / kChunks, c = (idx - r * kChunks) * 8;
      const bool ok = r < valid && c < hd;
      cp_async16(smem_u32(dst + r * LD + c), ok ? src + r * stride + c : any,
                 ok ? 16 : 0);
    }
  } else {
    for (int idx = tid; idx < rows * HD; idx += nthreads) {
      const int r = idx / HD, c = idx - r * HD;
      dst[r * LD + c] = (r < valid && c < hd) ? src[r * stride + c]
                                              : __float2bfloat16_rn(0.0f);
    }
  }
}

template <int HD, int BQ>
__global__ void __launch_bounds__(BQ * 2)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o,
                      float* __restrict__ lse, int BH, int Sq, int Sk, int H,
                      int Kv, int hd, int causal, int window, int q_offset,
                      int kv_offset, float scale_log2, int vec) {
  constexpr int kThreads = BQ * 2;  // one warp per 16 rows
  constexpr int LD = HD + 8;
  constexpr int KT = HD / 16;       // k-steps of QK^T over the head dim
  constexpr int NT = HD / 8;        // n-tiles of O over the head dim
  constexpr int SN = kBK / 8;       // n-tiles of S over a tile's keys
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // [BQ][LD]
  bf16* sK = sQ + BQ * LD;                         // [kStages][kBK][LD]
  bf16* sV = sK + kStages * kBK * LD;              // [kStages][kBK][LD]

  const int nq = (Sq + BQ - 1) / BQ;
  const int qt = nq - 1 - (int)(blockIdx.x / BH);  // far tiles first
  const int bh = (int)(blockIdx.x % BH);
  const int b = bh / H, h = bh - b * H;
  const int kvh = h / (H / Kv);
  const int q0 = qt * BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int nrows = min(BQ, Sq - q0);
  const int qpos_lo = q_offset + q0, qpos_hi = qpos_lo + nrows - 1;
  const int wq_lo = qpos_lo + warp * 16, wq_hi = wq_lo + 15;
  const bool warp_rows = warp * 16 < nrows;

  int s_begin = 0, s_end = Sk;
  if (causal) s_end = min(Sk, qpos_hi - kv_offset + 1);
  if (window > 0) s_begin = max(0, qpos_lo - window + 1 - kv_offset);
  const int kt_begin = s_begin / kBK;
  const int kt_end = s_end > s_begin ? (s_end + kBK - 1) / kBK : kt_begin;

  const long long q_stride = (long long)H * hd;
  const long long kv_stride = (long long)Kv * hd;
  const bf16* kbase = k + ((long long)b * Sk * Kv + kvh) * hd;
  const bf16* vbase = v + ((long long)b * Sk * Kv + kvh) * hd;

  // tile kt goes to stage (kt - kt_begin) % kStages, one commit group a
  // tile (the q tile joins the first)
  auto load_kv = [&](int kt) {
    if (kt < kt_end) {
      const int st = (kt - kt_begin) % kStages, k0 = kt * kBK;
      load_tile<HD, LD>(sK + st * kBK * LD, kbase + k0 * kv_stride, k,
                        kv_stride, kBK, Sk - k0, hd, vec, tid, kThreads);
      load_tile<HD, LD>(sV + st * kBK * LD, vbase + k0 * kv_stride, v,
                        kv_stride, kBK, Sk - k0, hd, vec, tid, kThreads);
    }
    cp_async_commit();
  };
  load_tile<HD, LD>(sQ, q + (((long long)b * Sq + q0) * H + h) * hd, q,
                    q_stride, BQ, nrows, hd, vec, tid, kThreads);
  for (int s = 0; s < kStages - 1; ++s) load_kv(kt_begin + s);
  cp_async_wait<kStages - 2>();
  __syncthreads();

  uint32_t qf[KT][4];
#pragma unroll
  for (int kk = 0; kk < KT; ++kk)
    ldmatrix_x4(qf[kk], smem_u32(sQ + (warp * 16 + (lane & 15)) * LD +
                                 kk * 16 + (lane >> 4) * 8));

  float oacc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
    oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.0f;
  float m_r[2] = {kNegInf, kNegInf};  // row max, in scale*log2(e) units
  float l_r[2] = {0.0f, 0.0f};        // this lane's part of the row sum
  const int pos0 = wq_lo + g, pos1 = pos0 + 8;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int stage = (kt - kt_begin) % kStages;
    cp_async_wait<kStages - 2>();  // this thread's copies of tile kt landed
    __syncthreads();  // everyone's, and every warp is done with tile kt - 1
    load_kv(kt + kStages - 1);     // into the stage that tile kt - 1 used

    const int k0 = kt * kBK;
    const int kpos_lo = kv_offset + k0;
    const int kpos_hi = kv_offset + min(k0 + kBK, Sk) - 1;
    const bool skip = !warp_rows || (causal && kpos_lo > wq_hi) ||
                      (window > 0 && wq_lo - kpos_hi >= window);
    if (!skip) {
      const bf16* cK = sK + stage * kBK * LD;
      const bf16* cV = sV + stage * kBK * LD;
      float s[SN][4];
#pragma unroll
      for (int n = 0; n < SN; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
#pragma unroll
        for (int nn = 0; nn < SN / 2; ++nn) {
          uint32_t kb[4];
          ldmatrix_x4(kb, smem_u32(cK + (nn * 16 + (lane & 7) +
                                         ((lane >> 4) << 3)) * LD +
                                   kk * 16 + ((lane >> 3) & 1) * 8));
          mma_bf16(s[2 * nn], qf[kk], kb[0], kb[1]);
          mma_bf16(s[2 * nn + 1], qf[kk], kb[2], kb[3]);
        }
      }

      const bool masked = k0 + kBK > Sk || (causal && kpos_hi > wq_lo) ||
                          (window > 0 && wq_hi - kpos_lo >= window);
      float mx0 = m_r[0], mx1 = m_r[1];
#pragma unroll
      for (int n = 0; n < SN; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[n][e] * scale_log2;
          if (masked) {
            const int col = k0 + n * 8 + 2 * t4 + (e & 1);
            const int kp = kv_offset + col;
            const int qp = e < 2 ? pos0 : pos1;
            const bool ok = col < Sk && (!causal || qp >= kp) &&
                            (window <= 0 || qp - kp < window);
            if (!ok) x = kNegInf;
          }
          s[n][e] = x;
        }
        mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
        mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float alpha0 = exp2f(m_r[0] - mx0);
      const float alpha1 = exp2f(m_r[1] - mx1);
      m_r[0] = mx0;
      m_r[1] = mx1;

      float rs0 = 0.0f, rs1 = 0.0f;
#pragma unroll
      for (int n = 0; n < SN; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float mx = e < 2 ? mx0 : mx1;
          float p = exp2f(s[n][e] - mx);
          if (masked && s[n][e] == kNegInf) p = 0.0f;
          s[n][e] = p;
        }
        rs0 += s[n][0] + s[n][1];
        rs1 += s[n][2] + s[n][3];
      }
      l_r[0] = l_r[0] * alpha0 + rs0;
      l_r[1] = l_r[1] * alpha1 + rs1;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        oacc[n][0] *= alpha0;
        oacc[n][1] *= alpha0;
        oacc[n][2] *= alpha1;
        oacc[n][3] *= alpha1;
      }

#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint32_t pa[4] = {
            pack_bf16(s[2 * kk][0], s[2 * kk][1]),
            pack_bf16(s[2 * kk][2], s[2 * kk][3]),
            pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
            pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int dd = 0; dd < HD / 16; ++dd) {
          uint32_t vb[4];
          ldmatrix_x4_trans(vb, smem_u32(cV + (kk * 16 + (lane & 15)) * LD +
                                         dd * 16 + (lane >> 4) * 8));
          mma_bf16(oacc[2 * dd], pa, vb[0], vb[1]);
          mma_bf16(oacc[2 * dd + 1], pa, vb[2], vb[3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 1);
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + warp * 16 + g + 8 * i;
    if (row >= Sq) continue;
    const float denom = fmaxf(l_r[i], 1e-30f);
    const float inv = 1.0f / denom;
    bf16* orow = o + (((long long)b * Sq + row) * H + h) * hd;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int d = n * 8 + 2 * t4;
      if (d < hd) orow[d] = __float2bfloat16_rn(oacc[n][2 * i] * inv);
      if (d + 1 < hd) orow[d + 1] = __float2bfloat16_rn(oacc[n][2 * i + 1] * inv);
    }
    if (t4 == 0)
      lse[((long long)b * H + h) * Sq + row] =
          l_r[i] > 0.0f ? m_r[i] * kLn2 + logf(denom) : kNegInf;
  }
}

template <int HD, int BQ>
int run_bf16(const void* q, const void* k, const void* v, void* o, void* lse,
             int B, int Sq, int Sk, int H, int Kv, int hd, int causal,
             int window, int q_offset, int kv_offset, int vec,
             void* stream) {
  const size_t smem =
      sizeof(bf16) * (size_t)(BQ + 2 * kStages * kBK) * (HD + 8);
  auto kern = flash_fwd_bf16_kernel<HD, BQ>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)B * H * ((Sq + BQ - 1) / BQ);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const float scale_log2 = kLog2e / sqrtf((float)hd);
  kern<<<(unsigned)blocks, BQ * 2, smem, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, (float*)lse,
      B * H, Sq, Sk, H, Kv, hd, causal, window, q_offset, kv_offset,
      scale_log2, vec);
  return (int)cudaGetLastError();
}

template <int HD>
int run_bf16_tiles(const void* q, const void* k, const void* v, void* o,
                   void* lse, int B, int Sq, int Sk, int H, int Kv, int hd,
                   int causal, int window, int q_offset, int kv_offset,
                   int vec, int sms, void* stream) {
  // 128-row q tiles only at hd 128 (measured on an H100: faster there, and
  // 64-row tiles faster at hd 64), and only where they fill one wave
  const long long blocks128 = (long long)B * H * ((Sq + 127) / 128);
  if (HD == 128 && blocks128 >= sms)
    return run_bf16<HD, 128>(q, k, v, o, lse, B, Sq, Sk, H, Kv, hd, causal,
                             window, q_offset, kv_offset, vec, stream);
  return run_bf16<HD, 64>(q, k, v, o, lse, B, Sq, Sk, H, Kv, hd, causal,
                          window, q_offset, kv_offset, vec, stream);
}

int launch_bf16(const void* q, const void* k, const void* v, void* o,
                void* lse, int B, int Sq, int Sk, int H, int Kv, int hd,
                int causal, int window, int q_offset, int kv_offset,
                void* stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const bool aligned = ((reinterpret_cast<uintptr_t>(q) |
                         reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  const int vec = (hd % 8 == 0 && aligned) ? 1 : 0;
  if (hd <= 16)
    return run_bf16_tiles<16>(q, k, v, o, lse, B, Sq, Sk, H, Kv, hd, causal,
                              window, q_offset, kv_offset, vec, sms, stream);
  if (hd <= 32)
    return run_bf16_tiles<32>(q, k, v, o, lse, B, Sq, Sk, H, Kv, hd, causal,
                              window, q_offset, kv_offset, vec, sms, stream);
  if (hd <= 64)
    return run_bf16_tiles<64>(q, k, v, o, lse, B, Sq, Sk, H, Kv, hd, causal,
                              window, q_offset, kv_offset, vec, sms, stream);
  return run_bf16_tiles<128>(q, k, v, o, lse, B, Sq, Sk, H, Kv, hd, causal,
                             window, q_offset, kv_offset, vec, sms, stream);
}

// --------------------------------------------------------------------------
// f32: CUDA cores
// --------------------------------------------------------------------------

constexpr int kF32BQ = 64;       // q rows per block
constexpr int kF32BK = 32;       // keys per k/v tile
constexpr int kF32Threads = 256; // 4 threads per q row
constexpr int kDimsPerThread = kMaxHd / 4;
constexpr int kColsPerThread = kF32BK / 4;

__global__ void __launch_bounds__(kF32Threads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int Sq, int Sk, int H, int Kv,
                     int hd, int causal, int window, int q_offset,
                     int kv_offset, float scale) {
  extern __shared__ float smem[];
  const int ld = hd + 1;
  float* sQ = smem;                  // [kF32BQ][ld]
  float* sK = sQ + kF32BQ * ld;      // [kF32BK][ld]
  float* sV = sK + kF32BK * ld;      // [kF32BK][ld]
  float* sP = sV + kF32BK * ld;      // [kF32BQ][kF32BK + 1]
  const int ldp = kF32BK + 1;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / Kv);
  const int q0 = blockIdx.y * kF32BQ;
  const int tid = threadIdx.x;
  const int r = tid >> 2, quarter = tid & 3;
  const int nrows = min(kF32BQ, Sq - q0);
  const bool row_ok = r < nrows;
  const int my_qpos = q_offset + q0 + r;
  const int qpos_lo = q_offset + q0, qpos_hi = q_offset + q0 + nrows - 1;

  for (int idx = tid; idx < kF32BQ * hd; idx += kF32Threads) {
    const int rr = idx / hd, d = idx - rr * hd;
    const int s = q0 + rr;
    sQ[rr * ld + d] = s < Sq ? q[(((long long)b * Sq + s) * H + h) * hd + d]
                             : 0.0f;
  }

  float m = kNegInf, l = 0.0f;
  float acc[kDimsPerThread];
#pragma unroll
  for (int i = 0; i < kDimsPerThread; ++i) acc[i] = 0.0f;

  for (int k0 = 0; k0 < Sk; k0 += kF32BK) {
    const int ncols = min(kF32BK, Sk - k0);
    const int kpos_lo = kv_offset + k0, kpos_hi = kpos_lo + ncols - 1;
    if (causal && kpos_lo > qpos_hi) break;               // beyond the diagonal
    if (window > 0 && qpos_lo - kpos_hi >= window) continue;  // before the window

    __syncthreads();  // the previous tile's readers are done with sK/sV/sP
    for (int idx = tid; idx < kF32BK * hd; idx += kF32Threads) {
      const int c = idx / hd, d = idx - c * hd;
      const int s = k0 + c;
      const long long off = (((long long)b * Sk + s) * Kv + kvh) * hd + d;
      const bool in = s < Sk;
      sK[c * ld + d] = in ? k[off] : 0.0f;
      sV[c * ld + d] = in ? v[off] : 0.0f;
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
      if (d < hd) o[base + d] = acc[i] / denom;
    }
    if (quarter == 0)
      lse[((long long)b * H + h) * Sq + q0 + r] = m + logf(denom);
  }
}

int launch_f32(const void* q, const void* k, const void* v, void* o,
               void* lse, int B, int Sq, int Sk, int H, int Kv, int hd,
               int causal, int window, int q_offset, int kv_offset,
               void* stream) {
  const size_t smem = sizeof(float) *
      ((size_t)(kF32BQ + 2 * kF32BK) * (hd + 1) + (size_t)kF32BQ * (kF32BK + 1));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)(B * H), (unsigned)((Sq + kF32BQ - 1) / kF32BQ));
  const float scale = 1.0f / sqrtf((float)hd);
  flash_fwd_f32_kernel<<<grid, kF32Threads, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o,
      (float*)lse, Sq, Sk, H, Kv, hd, causal, window, q_offset, kv_offset,
      scale);
  return (int)cudaGetLastError();
}

bool bad_shape(int B, int Sq, int Sk, int H, int Kv, int hd) {
  return B < 1 || Sq < 1 || Sk < 1 || Kv < 1 || H % Kv != 0 || hd < 1 ||
         hd > kMaxHd;
}

}  // namespace

extern "C" {

// q: (B, Sq, H, hd), k/v: (B, Sk, Kv, hd), o: like q, lse: (B, H, Sq) f32;
// all contiguous on the device.  window <= 0 means no window.
int flash_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                   void* lse, int B, int Sq, int Sk, int H, int Kv, int hd,
                   int causal, int window, int q_offset, int kv_offset,
                   void* stream) {
  if (bad_shape(B, Sq, Sk, H, Kv, hd)) return (int)cudaErrorInvalidValue;
  return launch_bf16(q, k, v, o, lse, B, Sq, Sk, H, Kv, hd, causal, window,
                     q_offset, kv_offset, stream);
}

int flash_fwd_f32(const void* q, const void* k, const void* v, void* o,
                  void* lse, int B, int Sq, int Sk, int H, int Kv, int hd,
                  int causal, int window, int q_offset, int kv_offset,
                  void* stream) {
  if (bad_shape(B, Sq, Sk, H, Kv, hd)) return (int)cudaErrorInvalidValue;
  return launch_f32(q, k, v, o, lse, B, Sq, Sk, H, Kv, hd, causal, window,
                    q_offset, kv_offset, stream);
}

}  // extern "C"
