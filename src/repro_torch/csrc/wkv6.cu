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
// Every exponent is of a number <= 0 (w <= 0 makes cum non-increasing);
// exp is never evaluated where it could be positive.
//
// Bound on an H100: bytes.  At RWKV6-7B's shape (r/k/v 1x2048x64x64 bf16,
// w f32, o f32) the call moves 118.5 MB (35 us at 3.35 TB/s) against ~5
// GFLOP of products.  Walking the chunks in order leaves most SMs idle (64
// heads), and the pairwise decay costs C(C-1)/2 * dk exps a chunk; each
// block's phases are latency-bound, so the design keeps many blocks in
// flight and their loads overlapping other blocks' work:
// - Chunk-parallel, one launch, with a decoupled look-back.  One block of
//   256 threads per (chunk, b*h, value tile of <= 64 columns): 2048 blocks
//   at RWKV6-7B's shape.  A block computes everything of its chunk that
//   does not need the chunk-start state S_c, including the chunk's state
//   contribution U_c = (k exp(cum_last - cum))^T @ v; then it waits for
//   the block of the previous chunk to publish S_c (a flag in global
//   memory, acquire / release), publishes S_c exp(cum_last) + U_c for the
//   next chunk (s_final for the last), and adds (r exp(base)) @ S_c to its
//   outputs.  Blocks take their work from an atomic ticket in chunk-major
//   order, so the block waited for holds a smaller ticket and is running
//   or done: the wait cannot deadlock (it is bounded anyway and traps).
//   The chunk-start states live in a scratch of B*H*n*dk*dv floats that
//   the wrapper allocates (33.6 MB at RWKV6-7B's shape, n = 32 chunks of
//   the kernel's 64 rows).
// - The kernel's own chunk.  Where a block for the caller's chunk would
//   leave no room for a second block on its SM (RWKV6: 128 rows, dk 64),
//   the chunk is computed in chunks of 64 rows; the recurrence is exact, so
//   only the rounding changes.  Hymba's per-head decay keeps 128.
// - Fewer exps.  Each chunk splits into 16-row sub-blocks.  For t in
//   sub-block i and s in an earlier sub-block j, exp(base[t] - cum[s]) is
//   factored at the sub-block boundaries: r[t] exp(base[t] - start_i),
//   a per-channel table exp(start_i - end_j), and k[s] exp(end_j - cum[s]),
//   every exponent <= 0 (w <= 0 makes cum non-increasing), so no factor
//   overflows, and where one underflows the true product is smaller
//   still.  The scores of j are then a tensor-core product of scaled r and
//   scaled k, each tile computed once by one of the 8 warps.  Only the
//   16 x 16 diagonal sub-blocks keep the pairwise form (s < t, plus the u
//   bonus or r.k on the diagonal), on the CUDA cores.  With a per-head
//   decay (w's last dim 1) the decay leaves the sum over d: A = (r k^T) *
//   exp(base[t] - cum[s]), one product of the raw inputs and one exp per
//   pair.
// - Tensor cores.  Every product (the scores, A @ v, (r exp(base)) @ S_c,
//   k^T @ v) is mma.sync.m16n8k8 in TF32 with f32 accumulators.  An f32
//   operand is split into hi + lo, both TF32 (cvt.rna), and the product is
//   hi*lo + lo*hi + hi*hi: ~2^-21 relative, against the 1e-4 * max|o|
//   tolerance that a plain TF32 or bf16 product of the decayed operands
//   would miss.  A bf16 input is exact in TF32 and is not split.  The
//   score tile's accumulator layout is the A@v operand's with the
//   k-index permuted (t <-> 2t, t+4 <-> 2t+1), so no shuffle is needed.
// - Loads: every tile's 16-byte loads are issued before any is stored, and
//   two blocks share an SM, so one block's loads overlap the other's work.
// Inputs are read in the (B, T, H, d) layout in place (64-bit offsets); a
// per-head decay (last dim 1) is read once per (b, t, h).  o is written in
// f32.  T must be a multiple of C: the wrapper pads a ragged T with k = 0
// and w = 0.  A chunk, dk and the value tile are zero-padded in shared
// memory to multiples of 16, 16 and 8.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <type_traits>

namespace {

constexpr int kThreads = 256;  // 8 warps; warp w owns the chunk's sub-block w
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDk = 64;
constexpr int kMaxDv = 128;
constexpr int kVTile = 64;
constexpr int kMaxChunk = 128;  // 8 sub-blocks of 16 rows
constexpr int kSub = 16;
// Where a block for the caller's chunk would not leave room for a second
// block on its SM, a chunk above 64 rows that 64 divides is computed in
// chunks of 64: the recurrence is exact, so only the rounding changes.
constexpr int kKernelChunk = 64;
constexpr size_t kTwoBlockSmem = 113 * 1024;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }
// the least y >= x with y % 32 == rem: a row stride that spreads a
// fragment's 32 reads over the 32 banks
__host__ __device__ inline int stride_for(int x, int rem) {
  return x + ((rem - x) % 32 + 32) % 32;
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// d += a (16x8, row) @ b (8x8, col), TF32 in, f32 accumulate
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An operand given as four (A) or two (B) f32 fragment values, split.
struct FragA {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ void set(float x0, float x1, float x2, float x3) {
    split(x0, hi[0], lo[0]);
    split(x1, hi[1], lo[1]);
    split(x2, hi[2], lo[2]);
    split(x3, hi[3], lo[3]);
  }
};
struct FragB {
  uint32_t hi[2], lo[2];
  __device__ __forceinline__ void set(float x0, float x1) {
    split(x0, hi[0], lo[0]);
    split(x1, hi[1], lo[1]);
  }
};

// d += a @ b as hi*lo + lo*hi + hi*hi; AX / BX: that operand is exact in
// TF32 (its lo is 0), so its lo term is skipped
template <bool AX, bool BX>
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a,
                                     const FragB& b) {
  if (!BX) mma_tf32(d, a.hi, b.lo[0], b.lo[1]);
  if (!AX) mma_tf32(d, a.lo, b.hi[0], b.hi[1]);
  mma_tf32(d, a.hi, b.hi[0], b.hi[1]);
}

// inclusive cumsum down the rows 1..Cp of buf (row 0 is zero), one column
// per channel, nseg row segments per column
__device__ void cumsum_rows(float* buf, int ld, int Cp, int dkp, int tid) {
  const int nseg = kThreads / dkp;
  const int seg_len = (Cp + nseg - 1) / nseg;
  const int d = tid % dkp, seg = tid / dkp;
  const bool active = seg < nseg;  // dkp = 48 leaves 16 threads out
  const int lo = 1 + seg * seg_len, hi = min(Cp, seg * seg_len + seg_len);
  float acc = 0.0f;
  if (active)
    for (int t = lo; t <= hi; ++t) {
      acc += buf[t * ld + d];
      buf[t * ld + d] = acc;
    }
  __syncthreads();
  float off = 0.0f;
  if (active)
    for (int s = 0; s < seg; ++s) {
      const int end = min(Cp, s * seg_len + seg_len);
      if (1 + s * seg_len <= end) off += buf[end * ld + d];
    }
  __syncthreads();
  if (active && seg > 0)
    for (int t = lo; t <= hi; ++t) buf[t * ld + d] += off;
  __syncthreads();
}

__device__ __forceinline__ void store_chunk(float* d, uint4 x, float) {
  *reinterpret_cast<float4*>(d) = make_float4(
      __uint_as_float(x.x), __uint_as_float(x.y), __uint_as_float(x.z),
      __uint_as_float(x.w));
}

__device__ __forceinline__ void store_chunk(float* d, uint4 x, __nv_bfloat16) {
  // a bf16 is the high half of its f32; the first of a pair is the low half
  *reinterpret_cast<float4*>(d) = make_float4(
      __uint_as_float(x.x << 16), __uint_as_float(x.x & 0xffff0000u),
      __uint_as_float(x.y << 16), __uint_as_float(x.y & 0xffff0000u));
  *reinterpret_cast<float4*>(d + 4) = make_float4(
      __uint_as_float(x.z << 16), __uint_as_float(x.z & 0xffff0000u),
      __uint_as_float(x.w << 16), __uint_as_float(x.w & 0xffff0000u));
}

// A rows x ncols block of a global array whose row i starts at src + i *
// step, staged into shared memory as f32 and zero-filled up to rows_pad x
// cols_pad (at most 128 x 64).  fetch() issues the 16-byte loads into
// registers and store() writes them, so that a block keeps the loads of
// all its tiles in flight at once.  Rows that are not whole 16-byte chunks
// are read element by element in store().
template <typename T>
struct TileFetch {
  static constexpr int E = 16 / sizeof(T);   // elements a chunk
  static constexpr int N = 128 * 64 / E / kThreads;
  uint4 buf[N];
  const T* src;
  long long step;
  int rows, ncols, rows_pad, cols_pad;
  bool vec;

  __device__ __forceinline__ void fetch(const T* src_, long long step_,
                                        int rows_, int ncols_, int rows_pad_,
                                        int cols_pad_, int tid) {
    src = src_;
    step = step_;
    rows = rows_;
    ncols = ncols_;
    rows_pad = rows_pad_;
    cols_pad = cols_pad_;
    vec = ncols % E == 0 && step % E == 0 &&
          (reinterpret_cast<uintptr_t>(src) & 15) == 0;
    if (!vec) return;
    const int cpr = cols_pad / E, total = rows_pad * cpr;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int idx = i * kThreads + tid;
      const int r = idx / cpr, c = (idx - r * cpr) * E;
      buf[i] = make_uint4(0u, 0u, 0u, 0u);
      if (idx < total && r < rows && c < ncols)
        buf[i] = __ldg(reinterpret_cast<const uint4*>(src + r * step + c));
    }
  }

  __device__ __forceinline__ void store(float* dst, int ld, int tid) const {
    if (vec) {
      const int cpr = cols_pad / E, total = rows_pad * cpr;
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const int idx = i * kThreads + tid;
        if (idx < total) {
          const int r = idx / cpr, c = (idx - r * cpr) * E;
          store_chunk(dst + r * ld + c, buf[i], T());
        }
      }
      return;
    }
    for (int idx = tid; idx < rows_pad * cols_pad; idx += kThreads) {
      const int r = idx / cols_pad, c = idx - r * cols_pad;
      dst[r * ld + c] =
          (r < rows && c < ncols) ? to_f32(src[r * step + c]) : 0.0f;
    }
  }
};

// One chunk's w into rows 1..C of sCum (row 0 and the rows past C zero):
// a per-channel decay through `fw` (fetched by the caller), a per-head one
// (wd == 1) read here and broadcast over d.
__device__ void store_w(float* sCum, int ldc, const TileFetch<float>& fw,
                        const float* w, long long row0, int H, int C, int Cp,
                        int dk, int dkp, int wd, int tid) {
  for (int d = tid; d < dkp; d += kThreads) sCum[d] = 0.0f;
  if (wd != 1) {
    fw.store(sCum + ldc, ldc, tid);
    return;
  }
  for (int t = tid; t < Cp; t += kThreads) {
    const float x = t < C ? w[row0 + (long long)t * H] : 0.0f;
    float* row = sCum + (t + 1) * ldc;
    for (int d = 0; d < dkp; ++d) row[d] = d < dk ? x : 0.0f;
  }
}

struct Dims {
  int Tn, H, BH, dk, dv, wd, C, Cp, dkp, n, dvt, nvtiles;
};

struct Layout {
  int ldk, ldv, lds;
  size_t r, k, cum, v, s, u, diag, e, f, g, x, a, total;
};

__host__ __device__ inline Layout layout(int Cp, int dkp, int dvtp,
                                         bool tiles) {
  Layout L;
  // fragment reads: R[t = g][d = t4], K[s = g][d = t4] and K[s = 2 t4][d =
  // g] (ldk = 4 mod 32), V[s = 2 t4][j = g] (ldv = 4), S[d = t4][j = g]
  // (lds = 8): each spreads a warp's 32 reads over the 32 banks
  L.ldk = stride_for(dkp, 4);
  L.ldv = stride_for(dvtp, 4);
  L.lds = stride_for(dvtp, 8);
  const int ns = Cp / kSub;
  L.r = 0;
  L.k = L.r + (size_t)Cp * L.ldk;
  L.cum = L.k + (size_t)Cp * L.ldk;
  L.v = L.cum + (size_t)(Cp + 1) * L.ldk;
  L.s = L.v + (size_t)Cp * L.ldv;
  L.u = L.s + (size_t)dkp * L.lds;
  L.diag = L.u + dkp;
  L.e = L.diag + (size_t)ns * kSub * (kSub + 1);
  L.f = L.e + (size_t)(ns + 1) * dkp;
  L.g = L.f + (size_t)ns * (ns - 1) / 2 * dkp;
  L.x = L.g + (size_t)ns * dkp;
  L.a = L.x + Cp;
  L.total = L.a + (tiles ? (size_t)ns * (ns - 1) / 2 * kSub * kSub : 0);
  return L;
}

__device__ __forceinline__ int load_acquire(const int* p) {
  int x;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(x) : "l"(p) : "memory");
  return x;
}

__device__ __forceinline__ void store_release(int* p, int x) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n"
               :: "l"(p), "r"(x) : "memory");
}

// o_acc += tile (16 x 16, in accumulator layout: at[nn] holds columns
// 8 nn..8 nn+7) @ V rows s0..s0+15, for the n-tiles [nlo, nhi).  The
// k-index of the product is permuted within each 8 columns (t <-> 2t,
// t+4 <-> 2t+1), which makes the accumulator layout the A operand's.
template <bool VX, int NV>
__device__ __forceinline__ void tile_times_v(float (&acc)[NV][4],
                                             const float (&at)[2][4],
                                             const float* sV, int ldv,
                                             int s0, int nlo, int nhi, int g,
                                             int t4) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    FragA a;
    a.set(at[kk][0], at[kk][2], at[kk][1], at[kk][3]);
    const float* v0 = sV + (s0 + 8 * kk + 2 * t4) * ldv + g;
#pragma unroll
    for (int nt = 0; nt < NV; ++nt) {
      if (nt >= nlo && nt < nhi) {
        FragB bf;
        bf.set(v0[nt * 8], v0[ldv + nt * 8]);
        mma3<false, VX>(acc[nt], a, bf);
      }
    }
  }
}

// The 16 x 16 score tile of rows in sub-block i and columns in sub-block
// j < i, in accumulator layout (at[nn] holds columns 8 nn..8 nn+7).
// Per-head decay: (r @ k^T) * exp(base[t] - cum[s]), raw inputs.
// Per-channel: (sR[t] sF[i, j]) . sK[s], the scaled r and k.
template <bool kExact>
__device__ __forceinline__ void score_tile(float (&at)[2][4], int i, int j,
                                           bool scalar, int boff,
                                           const float* sR, const float* sK,
                                           const float* sCum, const float* sF,
                                           int ldk, int dkp, int g, int t4) {
  const int sj = j * kSub;
  const int ta = i * kSub + g, tb = ta + 8;  // this lane's two rows
  const float* ra = sR + ta * ldk;
  const float* rb = sR + tb * ldk;
#pragma unroll
  for (int nn = 0; nn < 2; ++nn)
    at[nn][0] = at[nn][1] = at[nn][2] = at[nn][3] = 0.0f;
  if (scalar) {
#pragma unroll 2
    for (int d0 = 0; d0 < dkp; d0 += 8) {
      const int da = d0 + t4, db = da + 4;
      FragA a;
      a.set(ra[da], rb[da], ra[db], rb[db]);
#pragma unroll
      for (int nn = 0; nn < 2; ++nn) {
        const float* ks = sK + (sj + 8 * nn + g) * ldk;
        FragB bf;
        bf.set(ks[da], ks[db]);
        mma3<kExact, kExact>(at[nn], a, bf);
      }
    }
    const float base_a = sCum[(ta + boff) * ldk];  // column 0: per head
    const float base_b = sCum[(tb + boff) * ldk];
#pragma unroll
    for (int nn = 0; nn < 2; ++nn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int s = sj + 8 * nn + 2 * t4 + (e & 1);
        at[nn][e] *= __expf((e < 2 ? base_a : base_b) - sCum[(s + 1) * ldk]);
      }
    return;
  }
  const float* f = sF + (i * (i - 1) / 2 + j) * dkp;
#pragma unroll 2
  for (int d0 = 0; d0 < dkp; d0 += 8) {
    const int da = d0 + t4, db = da + 4;
    FragA a;
    a.set(ra[da] * f[da], rb[da] * f[da], ra[db] * f[db], rb[db] * f[db]);
#pragma unroll
    for (int nn = 0; nn < 2; ++nn) {
      const float* ks = sK + (sj + 8 * nn + g) * ldk;
      FragB bf;
      bf.set(ks[da], ks[db]);
      mma3<false, false>(at[nn], a, bf);
    }
  }
}

// One block per (chunk, b*h, value tile).  `sync` holds a ticket counter
// and one flag per (b*h, chunk, value tile): the chunk's start state is in
// `states`.  A block takes its work in ticket order, chunk-major, so the
// block it waits for (the same head's previous chunk) holds a smaller
// ticket and is already running or done.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
wkv_chunk_kernel(const T* __restrict__ r, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ w,
                 const float* __restrict__ u, const float* __restrict__ s0,
                 float* __restrict__ o, float* __restrict__ sf,
                 float* __restrict__ states, int* __restrict__ sync, Dims D) {
  constexpr bool kExact = std::is_same<T, __nv_bfloat16>::value;
  constexpr int NV = kVTile / 8;
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_ticket;
  const int dvtp = round_up(D.dvt, 8);
  const Layout L = layout(D.Cp, D.dkp, dvtp, D.wd != 1);
  float* sR = smem + L.r;      // [Cp][ldk]   r, then (per-channel) scaled
  float* sK = smem + L.k;      // [Cp][ldk]   k, then (per-channel) scaled
  float* sCum = smem + L.cum;  // [Cp+1][ldk] row 0 = 0, row t+1 = cum[t]
  float* sV = smem + L.v;      // [Cp][ldv]
  float* sS = smem + L.s;      // [dkp][lds]  the chunk-start state's tile
  float* sU = smem + L.u;      // [dkp]       u, or 1 (SSD)
  float* sE = smem + L.e;      // [NS+1][dkp] see below
  float* sF = smem + L.f;      // [NP][dkp]
  float* sG = smem + L.g;      // [NS][dkp]
  float* sX = smem + L.x;      // [Cp]        per-head decay: exp(cum_last - cum)
  float* sA = smem + L.a;      // [NP][256]   per-channel decay: score tiles
  const int ldk = L.ldk, ldv = L.ldv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int NS = D.Cp / kSub;

  if (tid == 0) s_ticket = atomicAdd(sync, 1);
  __syncthreads();
  const int per_chunk = D.BH * D.nvtiles;
  const int c = s_ticket / per_chunk;
  const int bh = (s_ticket - c * per_chunk) / D.nvtiles;
  const int vt = s_ticket - c * per_chunk - bh * D.nvtiles;
  const int b = bh / D.H, h = bh - b * D.H;
  const int j0 = vt * D.dvt;
  const int nv = min(D.dvt, D.dv - j0);
  const int nvt = dvtp / 8;
  const bool use_u = u != nullptr;
  const bool scalar = D.wd == 1;  // per-head decay
  const int boff = use_u ? 0 : 1;  // base[t] is sCum row t + boff
  const long long row0 = ((long long)b * D.Tn + (long long)c * D.C) * D.H + h;

  {
    const long long kstep = (long long)D.H * D.dk;
    TileFetch<T> fr, fk, fv;
    TileFetch<float> fw;
    fr.fetch(r + row0 * D.dk, kstep, D.C, D.dk, D.Cp, D.dkp, tid);
    fk.fetch(k + row0 * D.dk, kstep, D.C, D.dk, D.Cp, D.dkp, tid);
    fv.fetch(v + row0 * D.dv + j0, (long long)D.H * D.dv, D.C, nv, D.Cp,
             dvtp, tid);
    if (D.wd != 1)
      fw.fetch(w + row0 * D.wd, (long long)D.H * D.wd, D.C, D.dk, D.Cp,
               D.dkp, tid);
    fr.store(sR, ldk, tid);
    fk.store(sK, ldk, tid);
    fv.store(sV, ldv, tid);
    store_w(sCum, ldk, fw, w, row0, D.H, D.C, D.Cp, D.dk, D.dkp, D.wd, tid);
  }
  for (int d = tid; d < D.dkp; d += kThreads)
    sU[d] = (use_u && d < D.dk) ? u[h * D.dk + d] : 1.0f;
  __syncthreads();
  cumsum_rows(sCum, ldk, D.Cp, D.dkp, tid);

  // Warp w works on sub-block i = w % NS, and on the part w / NS of its
  // diagonal pairs and of the value n-tiles: with NS < 8 sub-blocks every
  // warp has work.
  const int hsplit = kWarps / NS;
  const bool active = warp < hsplit * NS;
  const int sb = warp % NS, part = warp / NS;
  const int t0 = sb * kSub;
  float* sD = smem + L.diag + sb * kSub * (kSub + 1);

  // diagonal sub-block, on the CUDA cores, from the raw r and k: pairs
  // s < t with their decay, and the diagonal (u bonus, or r.k)
  const int nq = D.dkp / 4;
  if (active) {
    // the diagonal entries, no exp: lanes 0..15 of the sub-block's first warp
    if (part == 0 && lane < kSub) {
      const float4* rt = reinterpret_cast<const float4*>(sR + (t0 + lane) * ldk);
      const float4* ks = reinterpret_cast<const float4*>(sK + (t0 + lane) * ldk);
      const float4* uu = reinterpret_cast<const float4*>(sU);
      float acc = 0.0f;
#pragma unroll 4
      for (int q = 0; q < nq; ++q) {
        const float4 x = rt[q], y = ks[q], z = uu[q];
        acc += x.x * z.x * y.x + x.y * z.y * y.y + x.z * z.z * y.z +
               x.w * z.w * y.w;
      }
      sD[lane * (kSub + 1) + lane] = acc;
    }
    // pairs s < t, p = t (t - 1) / 2 + s
    for (int p = lane + 32 * part; p < kSub * (kSub - 1) / 2;
         p += 32 * hsplit) {
      int tt = (int)((sqrtf(8.0f * p + 1.0f) + 1.0f) * 0.5f);
      while (tt * (tt - 1) / 2 > p) --tt;
      while ((tt + 1) * tt / 2 <= p) ++tt;
      const int ss = p - tt * (tt - 1) / 2;
      const float4* rt = reinterpret_cast<const float4*>(sR + (t0 + tt) * ldk);
      const float4* ks = reinterpret_cast<const float4*>(sK + (t0 + ss) * ldk);
      float acc = 0.0f;
      if (scalar) {
#pragma unroll 4
        for (int q = 0; q < nq; ++q) {
          const float4 x = rt[q], y = ks[q];
          acc += x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
        }
        acc *= __expf(sCum[(t0 + tt + boff) * ldk] -
                      sCum[(t0 + ss + 1) * ldk]);
      } else {
        const float4* bt =
            reinterpret_cast<const float4*>(sCum + (t0 + tt + boff) * ldk);
        const float4* cs =
            reinterpret_cast<const float4*>(sCum + (t0 + ss + 1) * ldk);
#pragma unroll 4
        for (int q = 0; q < nq; ++q) {
          const float4 x = rt[q], y = ks[q], e = bt[q], f = cs[q];
          acc += x.x * y.x * __expf(e.x - f.x) + x.y * y.y * __expf(e.y - f.y) +
                 x.z * y.z * __expf(e.z - f.z) + x.w * y.w * __expf(e.w - f.w);
        }
      }
      sD[tt * (kSub + 1) + ss] = acc;
      sD[ss * (kSub + 1) + tt] = 0.0f;
    }
  }

  // Tables, every exponent <= 0.  Row 16 i of sCum is the cum before
  // sub-block i (0 for i = 0), row Cp the chunk's last cum.
  //   sE[i]     = exp(cum before i); sE[NS] = exp(cum_last), the chunk decay
  // and for a per-channel decay:
  //   sF[i, j]  = exp(cum before i - cum at the end of j), j < i
  //   sG[j]     = exp(cum_last - cum at the end of j)
  //   sR[t]     = r[t] exp(base[t] - cum before t's sub-block)
  //   sK[s]     = k[s] exp(cum at the end of s's sub-block - cum[s])
  // so that r[t] exp(base[t]) = sR[t] sE[i], for s in j < i
  // r[t] k[s] exp(base[t] - cum[s]) = (sR[t] sF[i, j]) . sK[s], and
  // k[s] exp(cum_last - cum[s]) = sK[s] sG[j].  For a per-head decay:
  //   sX[s]     = exp(cum_last - cum[s])
  const int NP = NS * (NS - 1) / 2;
  for (int d = tid; d < D.dkp; d += kThreads)
    sE[NS * D.dkp + d] = expf(sCum[D.Cp * ldk + d]);
  if (scalar) {
    for (int t = tid; t < D.Cp; t += kThreads)
      sX[t] = __expf(sCum[D.Cp * ldk] - sCum[(t + 1) * ldk]);
  } else {
    __syncthreads();  // every warp is done with the raw r and k
    for (int idx = tid; idx < (2 * NS + NP) * D.dkp; idx += kThreads) {
      const int m = idx / D.dkp, d = idx - m * D.dkp;
      if (m < NS) {
        sE[m * D.dkp + d] = __expf(sCum[m * kSub * ldk + d]);
      } else if (m < NS + NP) {
        const int pp = m - NS;
        int i = 1;
        while ((i + 1) * i / 2 <= pp) ++i;
        const int j = pp - i * (i - 1) / 2;
        sF[pp * D.dkp + d] = __expf(sCum[i * kSub * ldk + d] -
                                    sCum[(j + 1) * kSub * ldk + d]);
      } else {
        const int j = m - NS - NP;
        sG[j * D.dkp + d] = __expf(sCum[D.Cp * ldk + d] -
                                   sCum[(j + 1) * kSub * ldk + d]);
      }
    }
#pragma unroll 4
    for (int idx = tid; idx < D.Cp * D.dkp; idx += kThreads) {
      const int t = idx / D.dkp, d = idx - t * D.dkp;
      const int start = (t / kSub) * kSub;
      sR[t * ldk + d] *= __expf(sCum[(t + boff) * ldk + d] -
                                sCum[start * ldk + d]);
      sK[t * ldk + d] *= __expf(sCum[(start + kSub) * ldk + d] -
                                sCum[(t + 1) * ldk + d]);
    }
  }
  __syncthreads();  // sD, the tables, and the scaled r and k are complete

  // Per-channel decay: the score tiles of earlier sub-blocks, each
  // computed once (tile p by warp p % 8) and stored in fragment order.  A
  // per-head decay's tiles are cheap (one product of the raw inputs) and
  // are computed where they are used.
  if (!scalar)
    for (int p = warp; p < NP; p += kWarps) {
      int i = 1;
      while ((i + 1) * i / 2 <= p) ++i;
      float at[2][4];
      score_tile<kExact>(at, i, p - i * (i - 1) / 2, false, boff, sR, sK,
                         sCum, sF, ldk, D.dkp, g, t4);
      float* tile = sA + p * kSub * kSub + lane;
#pragma unroll
      for (int nn = 0; nn < 2; ++nn)
#pragma unroll
        for (int e = 0; e < 4; ++e) tile[(nn * 4 + e) * 32] = at[nn][e];
    }

  // The chunk's state contribution U = (k exp(cum_last - cum))^T @ v
  // (dkp x dvtp): warp w owns the m-tile w % mt and a share of the
  // n-tiles, its accumulators sharing each A fragment; the k-index is
  // permuted as in tile_times_v.
  const int mt = D.dkp / 16;
  const int groups = kWarps / mt;  // mt <= 4
  const int grp = warp / mt, m0 = (warp % mt) * 16;
  const int per_u = (nvt + groups - 1) / groups;  // <= 4
  const int ulo = grp * per_u, uhi = min(nvt, ulo + per_u);
  float accu[4][4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
    accu[q][0] = accu[q][1] = accu[q][2] = accu[q][3] = 0.0f;
  if (grp < groups) {
#pragma unroll 2
    for (int s0r = 0; s0r < D.Cp; s0r += 8) {
      const int sa = s0r + 2 * t4, sc = sa + 1;
      const float* ka = sK + sa * ldk + m0 + g;
      const float* kc = sK + sc * ldk + m0 + g;
      float fa0, fa1, fc0, fc1;  // the factors of rows sa, sc at m0+g, +8
      if (scalar) {
        fa0 = fa1 = sX[sa];
        fc0 = fc1 = sX[sc];
      } else {
        const float* gj = sG + (s0r / kSub) * D.dkp + m0 + g;
        fa0 = fc0 = gj[0];
        fa1 = fc1 = gj[8];
      }
      FragA a;
      a.set(ka[0] * fa0, ka[8] * fa1, kc[0] * fc0, kc[8] * fc1);
      const float* va = sV + sa * ldv + g;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int n0 = (ulo + q) * 8;
        if (ulo + q < uhi) {
          FragB bf;
          bf.set(va[n0], va[ldv + n0]);
          mma3<false, kExact>(accu[q], a, bf);
        }
      }
    }
  }
  __syncthreads();  // the score tiles are complete

  // intra-chunk: the score tiles of earlier sub-blocks j < sb (from sA),
  // then the diagonal sub-block, each times its rows of v
  const int per = (nvt + hsplit - 1) / hsplit;
  const int nlo = part * per, nhi = min(nvt, nlo + per);
  float acc[NV][4];
#pragma unroll
  for (int nt = 0; nt < NV; ++nt)
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0f;
  if (active) {
    for (int j = 0; j < sb; ++j) {
      float at[2][4];
      if (scalar) {
        score_tile<kExact>(at, sb, j, true, boff, sR, sK, sCum, sF, ldk,
                           D.dkp, g, t4);
      } else {
        const float* tile = sA + (sb * (sb - 1) / 2 + j) * kSub * kSub + lane;
#pragma unroll
        for (int nn = 0; nn < 2; ++nn)
#pragma unroll
          for (int e = 0; e < 4; ++e) at[nn][e] = tile[(nn * 4 + e) * 32];
      }
      tile_times_v<kExact, NV>(acc, at, sV, ldv, j * kSub, nlo, nhi, g, t4);
    }
    float at[2][4];
#pragma unroll
    for (int nn = 0; nn < 2; ++nn)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        at[nn][e] = sD[(g + (e >> 1) * 8) * (kSub + 1) + 8 * nn + 2 * t4 +
                       (e & 1)];
    tile_times_v<kExact, NV>(acc, at, sV, ldv, t0, nlo, nhi, g, t4);
  }

  // the chunk-start state: s0 (or 0) for the first chunk, else published
  // by the previous chunk's block
  const long long ssz = (long long)D.dk * D.dv;
  const float* src = c > 0 ? states + ((long long)bh * D.n + c) * ssz
                   : s0 != nullptr ? s0 + (long long)bh * ssz : nullptr;
  if (c > 0) {
    if (tid == 0) {
      const int* flag = sync + 1 + ((long long)bh * D.n + c) * D.nvtiles + vt;
      for (long long spin = 0; load_acquire(flag) == 0; ++spin) {
        if (spin > (1LL << 24)) __trap();  // never: the producer runs
        __nanosleep(64);
      }
    }
    __syncthreads();
  }
  if (src != nullptr && nv % 4 == 0 && D.dv % 4 == 0 && j0 % 4 == 0 &&
      (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int q4 = dvtp / 4;
    for (int idx = tid; idx < D.dkp * q4; idx += kThreads) {
      const int d = idx / q4, j = (idx - d * q4) * 4;
      const float4 x = (d < D.dk && j < nv)
          ? __ldcg(reinterpret_cast<const float4*>(src + (long long)d * D.dv +
                                                   j0 + j))
          : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      *reinterpret_cast<float4*>(sS + d * L.lds + j) = x;
    }
  } else {
    for (int idx = tid; idx < D.dkp * dvtp; idx += kThreads) {
      const int d = idx / dvtp, j = idx - d * dvtp;
      sS[d * L.lds + j] = (src != nullptr && d < D.dk && j < nv)
          ? __ldcg(src + (long long)d * D.dv + j0 + j) : 0.0f;
    }
  }
  __syncthreads();

  // publish the next chunk's start state S * exp(cum_last) + U (the last
  // chunk's is s_final)
  if (grp < groups) {
    float* dst = c + 1 < D.n ? states + ((long long)bh * D.n + c + 1) * ssz
                             : sf + (long long)bh * ssz;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int n0 = (ulo + q) * 8;
      if (ulo + q >= uhi) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = m0 + g + (e >> 1) * 8, j = n0 + 2 * t4 + (e & 1);
        if (d < D.dk && j < nv)
          dst[(long long)d * D.dv + j0 + j] =
              sS[d * L.lds + j] * sE[NS * D.dkp + d] + accu[q][e];
      }
    }
  }
  if (c + 1 < D.n) {
    __threadfence();
    __syncthreads();
    if (tid == 0)
      store_release(sync + 1 + ((long long)bh * D.n + c + 1) * D.nvtiles + vt,
                    1);
  }

  if (!active) return;
  // inter-chunk: (r * exp(base)) @ S_c
  {
    const int ta = t0 + g, tb = ta + 8;  // this lane's two rows
    const float* ra = sR + ta * ldk;
    const float* rb = sR + tb * ldk;
    const float base_a = sCum[(ta + boff) * ldk];  // column 0: per head
    const float base_b = sCum[(tb + boff) * ldk];
    const float ea = scalar ? __expf(base_a) : 0.0f;
    const float eb = scalar ? __expf(base_b) : 0.0f;
    const float* e = sE + sb * D.dkp;
#pragma unroll 2
    for (int d0 = 0; d0 < D.dkp; d0 += 8) {
      const int da = d0 + t4, db = da + 4;
      FragA a;
      if (scalar)
        a.set(ra[da] * ea, rb[da] * eb, ra[db] * ea, rb[db] * eb);
      else
        a.set(ra[da] * e[da], rb[da] * e[da], ra[db] * e[db], rb[db] * e[db]);
      const float* sd = sS + da * L.lds + g;
#pragma unroll
      for (int nt = 0; nt < NV; ++nt) {
        if (nt >= nlo && nt < nhi) {
          FragB bf;
          bf.set(sd[nt * 8], sd[4 * L.lds + nt * 8]);
          mma3<false, false>(acc[nt], a, bf);
        }
      }
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int t = t0 + g + 8 * half;
    if (t >= D.C) continue;
    float* orow = o + (row0 + (long long)t * D.H) * D.dv + j0;
#pragma unroll
    for (int nt = 0; nt < NV; ++nt) {
      if (nt < nlo || nt >= nhi) continue;
      const int j = nt * 8 + 2 * t4;
      if (j < nv) orow[j] = acc[nt][2 * half];
      if (j + 1 < nv) orow[j + 1] = acc[nt][2 * half + 1];
    }
  }
}

__host__ inline int kernel_chunk(int C, int dk, int dv, int wd) {
  const int dvt = dv < kVTile ? dv : kVTile;
  const size_t smem = sizeof(float) *
      layout(round_up(C, kSub), round_up(dk, 16), round_up(dvt, 8), wd != 1)
          .total;
  if (smem <= kTwoBlockSmem) return C;
  return (C > kKernelChunk && C % kKernelChunk == 0) ? kKernelChunk : C;
}

struct Scratch {
  long long states, flags;  // floats of chunk states, ints of sync
};

__host__ inline Scratch scratch_size(int B, int T, int H, int dk, int dv,
                                     int wd, int C) {
  const int n = T / kernel_chunk(C, dk, dv, wd);
  const int nvtiles = (dv + kVTile - 1) / kVTile;
  Scratch S;
  S.states = (long long)B * H * n * dk * dv;
  S.flags = 1 + (long long)B * H * n * nvtiles;
  return S;
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* s0, void* o, void* sf, void* scratch,
           long long scratch_floats, int B, int Tn, int H, int dk, int dv,
           int wd, int C, void* stream) {
  if (B < 1 || H < 1 || Tn < 1 || C < 1 || C > kMaxChunk || Tn % C != 0 ||
      dk < 1 || dk > kMaxDk || dv < 1 || dv > kMaxDv ||
      (wd != 1 && wd != dk))
    return (int)cudaErrorInvalidValue;
  Dims D;
  D.Tn = Tn;
  D.H = H;
  D.BH = B * H;
  D.dk = dk;
  D.dv = dv;
  D.wd = wd;
  D.C = kernel_chunk(C, dk, dv, wd);
  D.Cp = round_up(D.C, kSub);
  D.dkp = round_up(dk, 16);
  D.n = Tn / D.C;
  D.dvt = dv < kVTile ? dv : kVTile;
  D.nvtiles = (dv + D.dvt - 1) / D.dvt;
  const long long blocks = (long long)B * H * D.n * D.nvtiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const Scratch S = scratch_size(B, Tn, H, dk, dv, wd, C);
  if (S.states + S.flags > scratch_floats) return (int)cudaErrorInvalidValue;
  float* states = (float*)scratch;
  int* sync = (int*)(states + S.states);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(sync, 0, sizeof(int) * S.flags, st);
  if (err != cudaSuccess) return (int)err;
  const size_t smem =
      sizeof(float) * layout(D.Cp, D.dkp, round_up(D.dvt, 8), wd != 1).total;
  err = cudaFuncSetAttribute(wkv_chunk_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  wkv_chunk_kernel<T><<<(unsigned)blocks, kThreads, smem, st>>>(
      (const T*)r, (const T*)k, (const T*)v, (const float*)w,
      (const float*)u, (const float*)s0, (float*)o, (float*)sf, states, sync,
      D);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// r/k: (B, T, H, dk), v: (B, T, H, dv), w: (B, T, H, wd) f32 with wd 1 or
// dk, u: (H, dk) f32 or null (SSD), s0: (B, H, dk, dv) f32 or null (zero),
// o: (B, T, H, dv) f32, sf: (B, H, dk, dv) f32, scratch: scratch_floats
// f32 (the wrapper sizes it for chunks of min(C, kKernelChunk) rows and
// value tiles of kVTile; a launch that needs more is refused); all
// contiguous on the device, T % C == 0.
int wkv6_bf16(const void* r, const void* k, const void* v, const void* w,
              const void* u, const void* s0, void* o, void* sf,
              void* scratch, long long scratch_floats, int B, int T, int H,
              int dk, int dv, int wd, int C, void* stream) {
  return launch<__nv_bfloat16>(r, k, v, w, u, s0, o, sf, scratch,
                               scratch_floats, B, T, H, dk, dv, wd, C,
                               stream);
}

int wkv6_f32(const void* r, const void* k, const void* v, const void* w,
             const void* u, const void* s0, void* o, void* sf, void* scratch,
             long long scratch_floats, int B, int T, int H, int dk, int dv,
             int wd, int C, void* stream) {
  return launch<float>(r, k, v, w, u, s0, o, sf, scratch, scratch_floats, B,
                       T, H, dk, dv, wd, C, stream);
}

}  // extern "C"
