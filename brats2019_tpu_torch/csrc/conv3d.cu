// SAME stride-1 3x3x3 conv3d for NDHWC volumes, no bias, in two instances:
// bf16 in, f32 accumulation, bf16 out (conv3d_ndhwc_bf16, tensor cores), and
// f32 in, f32 FFMA accumulation, f32 out (conv3d_ndhwc_f32, and its form with
// an InstanceNorm-statistics epilogue conv3d_stats_ndhwc_f32, at the end of
// this file). Built by brats2019_tpu_torch/ops/_build.py with
// nvcc -gencode arch=compute_90a,code=sm_90a; called through ctypes from
// brats2019_tpu_torch/ops/conv.py (conv3d).
//
// Replaces: brats2019_tpu/ops/pallas_conv.py conv3d_pallas (:79, kernel
// _kernel :41), and the XLA conv of models/blocks.py:35-43 that the JAX
// package runs by default. Same function: y[n,d,h,w,co] =
// sum_{kd,kh,kw,ci} x[n,d+kd-1,h+kh-1,w+kw-1,ci] * w[kd,kh,kw,ci,co], with
// zeros outside the volume.
//
// What bounds it on the card: tensor-core throughput. Every conv of the
// flagship nets has K = 27*Ci >= 864 and Co >= 48, i.e. hundreds of flops per
// byte, far above the H100's ~295 flop/byte bf16 ridge; the whole predict
// program is ~4.5 TFLOP per volume.
//
// Design (a simple implicit GEMM; wgmma + TMA + a deeper ring come later):
//   * GEMM view: M = N*D*H*W output voxels, N = Co, K = 27*Ci ordered
//     (tap, ci). The DHWIO weight flattened is exactly the K-major
//     (27*Ci, Co) B operand, so B needs no repack.
//   * A block computes a 128 x 64 output tile with 8 warps (4 x 2), each
//     warp 32 x 32 through 2 x 2 WMMA m16n16k16 bf16 fragments (mma.sync).
//   * K advances one (tap, 32-channel chunk) at a time. Inside a chunk all
//     rows share one spatial shift, so a row's 32 channels are contiguous in
//     memory: 16-byte cp.async loads, double-buffered in shared memory.
//   * The halo is masked in the loader (cp.async with src-size 0
//     zero-fills), never by padding a copy, so any D, H, W works (the Pallas
//     kernel needs D, H, W % 8 == 0 and misses the coarse net's (24,28,20)
//     and (12,14,10) levels).
//   * Ci or Co not a multiple of 8 takes a scalar-load instance of the same
//     kernel. Ci tails inside a chunk and Co tails are zero-filled.
//   * The f32 accumulators are staged through shared memory and written as
//     bf16 (round to nearest even), 16 bytes per thread.
//   * No atomics, fixed summation order: repeat runs are bitwise equal.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BM = 128;       // output voxels per block
constexpr int BN = 64;        // output channels per block
constexpr int BK = 32;        // contraction chunk: 32 channels of one tap
constexpr int THREADS = 256;  // 8 warps: 4 along M x 2 along N
constexpr int A_LD = BK + 8;  // shared row pitch in elements (16B aligned)
constexpr int B_LD = BN + 8;
constexpr int C_LD = BN + 4;
constexpr int A_STAGE = BM * A_LD;
constexpr int B_STAGE = BK * B_LD;
constexpr int PIPE_BYTES = 2 * (A_STAGE + B_STAGE) * 2;
constexpr int EPI_BYTES = BM * C_LD * 4;
constexpr int SMEM_BYTES = PIPE_BYTES > EPI_BYTES ? PIPE_BYTES : EPI_BYTES;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = valid ? 16 : 0;  // src-size 0: write 16 zero bytes, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_0() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
    conv3d_kernel(const __nv_bfloat16* __restrict__ x,
                  const __nv_bfloat16* __restrict__ w,
                  __nv_bfloat16* __restrict__ y, int N, int D, int H, int W,
                  int Ci, int Co) {
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = As + 2 * A_STAGE;
  float* Cs = reinterpret_cast<float*>(smem);  // epilogue reuses the ring

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp >> 1;
  const int wn = warp & 1;
  const long long M = (long long)N * D * H * W;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const long long HW = (long long)H * W;

  // A loader: each thread owns 8 channels of rows r and r + 64 for the
  // whole K loop, so the voxel coordinates are decoded once
  const int a_col = (tid & 3) * 8;
  int a_row[2], a_d[2], a_h[2], a_w[2];
  long long a_m[2];
  bool a_in[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    a_row[i] = (tid >> 2) + i * 64;
    long long m = m0 + a_row[i];
    a_in[i] = m < M;
    long long mm = a_in[i] ? m : 0;
    a_m[i] = mm;
    a_w[i] = (int)(mm % W);
    long long t = mm / W;
    a_h[i] = (int)(t % H);
    t /= H;
    a_d[i] = (int)(t % D);
  }
  // B loader: 32 rows x 64 channels, 8 channels per thread
  const int b_row = tid >> 3;
  const int b_col = (tid & 7) * 8;

  const int n_ci_chunks = (Ci + BK - 1) / BK;
  const int n_chunks = 27 * n_ci_chunks;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  auto load_chunk = [&](int c, int stage) {
    const int tap = c / n_ci_chunks;
    const int ci0 = (c - tap * n_ci_chunks) * BK;
    const int kd = tap / 9, kh = (tap / 3) % 3, kw = tap % 3;
    const long long shift = (kd - 1) * HW + (long long)(kh - 1) * W + (kw - 1);
    __nv_bfloat16* as = As + stage * A_STAGE;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int dd = a_d[i] + kd - 1, hh = a_h[i] + kh - 1,
                ww = a_w[i] + kw - 1;
      const bool ok = a_in[i] && dd >= 0 && dd < D && hh >= 0 && hh < H &&
                      ww >= 0 && ww < W;
      const long long src = (a_m[i] + shift) * Ci + ci0 + a_col;
      __nv_bfloat16* dst = as + a_row[i] * A_LD + a_col;
      if (VEC) {
        const bool v = ok && (ci0 + a_col < Ci);
        cp_async16(dst, v ? (const void*)(x + src) : (const void*)x, v);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int ci = ci0 + a_col + j;
          dst[j] = (ok && ci < Ci) ? x[src + j] : zero;
        }
      }
    }
    const int k = ci0 + b_row;
    const long long wsrc = ((long long)tap * Ci + k) * Co + n0 + b_col;
    __nv_bfloat16* bd = Bs + stage * B_STAGE + b_row * B_LD + b_col;
    if (VEC) {
      const bool v = (k < Ci) && (n0 + b_col < Co);
      cp_async16(bd, v ? (const void*)(w + wsrc) : (const void*)w, v);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int co = n0 + b_col + j;
        bd[j] = (k < Ci && co < Co) ? w[wsrc + j] : zero;
      }
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  load_chunk(0, 0);
  cp_async_commit();
  for (int c = 0; c < n_chunks; ++c) {
    const int stage = c & 1;
    if (c + 1 < n_chunks) {
      load_chunk(c + 1, stage ^ 1);
      cp_async_commit();
      cp_async_wait_1();
    } else {
      cp_async_wait_0();
    }
    __syncthreads();
    const __nv_bfloat16* as = As + stage * A_STAGE;
    const __nv_bfloat16* bs = Bs + stage * B_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major>
          af[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major>
          bf[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(af[i], as + (wm * 32 + i * 16) * A_LD + kk,
                               A_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bf[j], bs + kk * B_LD + wn * 32 + j * 16,
                               B_LD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#ifndef CONV3D_LOADS_ONLY  // a probe build times the fills alone
          wmma::mma_sync(acc[i][j], af[i], bf[j], acc[i][j]);
#else
          ;
#endif
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * C_LD + wn * 32 + j * 16,
                              acc[i][j], C_LD, wmma::mem_row_major);
  __syncthreads();

  for (int e = tid; e < BM * (BN / 8); e += THREADS) {
    const int r = e / (BN / 8);
    const int cg = (e % (BN / 8)) * 8;
    const long long m = m0 + r;
    const int co = n0 + cg;
    if (m >= M) continue;
    const float* src = Cs + r * C_LD + cg;
    __nv_bfloat16* dst = y + m * Co + co;
    if (VEC) {
      if (co < Co) {
        __align__(16) __nv_bfloat16 v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = __float2bfloat16(src[j]);
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
      }
    } else {
      for (int j = 0; j < 8 && co + j < Co; ++j)
        dst[j] = __float2bfloat16(src[j]);
    }
  }
}

}  // namespace

// x (N,D,H,W,Ci), w (3,3,3,Ci,Co), y (N,D,H,W,Co): contiguous bf16 on the
// current device. Launches on `stream`; returns cudaGetLastError().
extern "C" int conv3d_ndhwc_bf16(const void* x, const void* w, void* y, int N,
                                 int D, int H, int W, int Ci, int Co,
                                 void* stream) {
  const long long M = (long long)N * D * H * W;
  dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((Co + BN - 1) / BN));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* wb = static_cast<const __nv_bfloat16*>(w);
  auto* yb = static_cast<__nv_bfloat16*>(y);
  if (Ci % 8 == 0 && Co % 8 == 0)
    conv3d_kernel<true><<<grid, THREADS, 0, s>>>(xb, wb, yb, N, D, H, W, Ci, Co);
  else
    conv3d_kernel<false><<<grid, THREADS, 0, s>>>(xb, wb, yb, N, D, H, W, Ci,
                                                  Co);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The f32 instance: what a configuration with compute_dtype "float32" runs
// (the presets unit and smoke, the accuracy benchmark's config). The JAX
// package computes those convs in f32 on every backend, so this one does too:
// f32 operands, f32 FFMA accumulation on the CUDA cores, f32 out. No tensor
// cores (no TF32: it keeps about three decimal digits).
//
// What bounds it on the card: the FP32 pipe, 67 TFLOP/s dense on an H100 SXM;
// a conv of the f32 configurations does 27 * Ci * 2 flops per output value
// against 4 + 4 bytes, far above the f32 ridge (~20 flop/byte). Their
// channel counts are small (Ci 3-48, Co 4-48), so what decides the time is
// how many FFMA slots go to padding and how many shared-memory
// loads feed each FFMA.
//
// Design (csrc/conv3d_wgmma.cu's box of voxels and halo patch, on FFMA):
//   * A block owns a box of BD x 8 x 8 output voxels of one sample (BD 2, 4
//     or 8, chosen by ops/conv.py plan_conv from the number of blocks) and a
//     Co tile of CT channels sized to Co (4, 8, 12, ..., 64; wider Co walks
//     several tiles), so no FFMA runs on a zero column where Co % 4 == 0 and
//     Co <= 64.
//   * Ci is consumed in slabs of SL channels (a multiple of 4, the whole Ci
//     where it fits the plan's shared-memory budget; the last slab ends at Ci
//     rounded up to 4). Per slab the
//     (BD+2) x 10 x 10 halo patch goes to shared memory once, by zero-filling
//     16-byte cp.async of 4-channel runs where Ci % 4 == 0 and Co % 4 == 0
//     (masked scalar loads otherwise), and the block's Co tile of the weight,
//     27 x SL x CT, beside it. All 27 taps then read the patch: no input
//     voxel is fetched from memory twice by one block within a slab. SAME
//     padding is the zero fill; Ci is padded to a multiple of 4 only.
//   * A thread owns 4 consecutive w voxels x CPT channels (CPT 8 where
//     CT % 8 == 0, else 4). For each (kd, kh) and 4 channels it reads the 6
//     patch voxels that cover the 3 kw taps as float4s and, per channel and
//     kw, CPT weights as warp-wide broadcast float4s: 6 + 6 * CPT / 4 loads
//     per 48 * CPT FFMA (30 per 384 at CPT 8). The patch row pitch is padded
//     to an odd number of 16-byte units, and the 8 lanes of a quarter-warp
//     hold the box's 8 h-rows, so those float4 reads never conflict; the
//     lanes of a warp share their Co group, so the weights broadcast.
//   * Each output's sum runs over (slab, kd, kh, channel, kw) in one fixed
//     order: repeat runs are bitwise equal.
//   * Ragged boxes and Co tails are masked at the store.
//
// The STATS instance (conv3d_stats_ndhwc_f32) also writes, for every (sample,
// box, output channel), the InstanceNorm statistics of the values it stores,
// so that the norm after the conv need not read y a first time (replaces the
// statistics pass of brats2019_tpu/ops/pallas_norm.py _fwd_pallas, :176, for
// the f32 configurations; the merge and the apply pass are ops/triton_norm.py,
// as for the bf16 STATS epilogue of csrc/conv3d_wgmma.cu). Its epilogue, after
// the stores, which stay as they are (y is bitwise the plain instance's):
//   * takes each value as stored (f32) and only the box's voxels inside the
//     volume; the count of a box is its extent inside the volume;
//   * two passes, the box's sum and then the centred sum of squares around
//     the box's mean (never E[x^2] - mean^2);
//   * one fixed order: a thread folds its 4 w voxels in turn, the 32 lanes of
//     a warp (one Co group) by an xor butterfly (16, 8, 4, 2, 1), then the
//     BD / 2 warps of the Co group in turn through shared memory, which reuses
//     the patch behind a barrier. No atomics: repeats are bitwise equal;
//   * writes (count, mean, M2) in f32 to partials[3][n][box][co], boxes
//     numbered (bd * nbh + bh) * nbw + bw, the Co tile's own channels (the Co
//     tail masked).
//
// Probe builds (tools/torch_conv_check.py --f32 --probe), for timing only:
// -DCONV3D_F32_FILLS_ONLY leaves out the products, -DCONV3D_F32_NO_STORE the
// stores; -DCONV3D_F32_MAXNREG=n caps the registers.

namespace {

constexpr int F_BH = 8, F_BW = 8;            // box extent along h and w
constexpr int F_PH = F_BH + 2, F_PW = F_BW + 2;
constexpr int F_MAX_THREADS = 512;
constexpr int F_SMEM_LIMIT = 232448;         // dynamic shared memory a block may ask for

// Floats of one patch row (F_PW voxels of a slab of `slab` channels, slab %
// 4 == 0), rounded up to an odd number of 16-byte units.
__host__ __device__ constexpr int f32_row_pitch(int slab) {
  return 4 * ((F_PW * slab / 4) | 1);
}

__host__ __device__ constexpr int f32_smem_bytes(int bd, int ct, int slab) {
  return 4 * ((bd + 2) * F_PH * f32_row_pitch(slab) + 27 * slab * ct);
}

__device__ __forceinline__ float lane_of(const float4& v, int k) {
  return k == 0 ? v.x : (k == 1 ? v.y : (k == 2 ? v.z : v.w));
}

// A probe build may cap the registers (-DCONV3D_F32_MAXNREG=n) to read what
// occupancy buys.
#ifdef CONV3D_F32_MAXNREG
#define F32_BOUNDS __maxnreg__(CONV3D_F32_MAXNREG)
#else
#define F32_BOUNDS __launch_bounds__(F_MAX_THREADS)
#endif

// The STATS epilogue of one block (see the head of this part): (count, mean,
// M2) of each of the Co tile's channels over the box's voxels inside the
// volume. `ok[v]`: this thread's voxel v lies inside the volume. Every thread
// of the block calls it (it holds barriers); `scratch` is the patch's space.
template <int CPT>
__device__ __forceinline__ void f32_box_stats(
    const float (&acc)[4][CPT], const bool (&ok)[4], float* scratch,
    float* __restrict__ part, int N, int D, int H, int W, int Co, int BD, int CT,
    int n, int box, int nboxes, int d0, int h0, int w0, int co0, int g, int vt,
    int tid) {
  const int lane = tid & 31;
  const int nwg = BD / 2;         // warps of a Co group (16 * BD threads)
  const int wig = vt >> 5;        // this warp's place in its group
  float* red = scratch;           // [nwg][CT]
  float* box_mean = scratch + nwg * CT;
  const float cnt = (float)(min(BD, D - d0) * min(F_BH, H - h0) *
                            min(F_BW, W - w0));
  float s[CPT];
  auto reduce = [&]() {           // s of the warp's 32 lanes, to red
#pragma unroll
    for (int off = 16; off; off >>= 1)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[j] += __shfl_xor_sync(0xffffffffu, s[j], off);
    if (lane == 0)
#pragma unroll
      for (int j = 0; j < CPT; ++j) red[wig * CT + g * CPT + j] = s[j];
  };
  __syncthreads();                // every thread is done with the patch
  // pass 1: the box's sum of each channel
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    float t = 0.f;
#pragma unroll
    for (int v = 0; v < 4; ++v) t += ok[v] ? acc[v][j] : 0.f;
    s[j] = t;
  }
  reduce();
  __syncthreads();
  if (tid < CT) {
    float t = red[tid];
    for (int k = 1; k < nwg; ++k) t += red[k * CT + tid];
    box_mean[tid] = t / cnt;
  }
  __syncthreads();
  // pass 2: the centred sum of squares around the box's mean
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    const float mu = box_mean[g * CPT + j];
    float t = 0.f;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const float dv = acc[v][j] - mu;
      t = ok[v] ? fmaf(dv, dv, t) : t;
    }
    s[j] = t;
  }
  reduce();
  __syncthreads();
  if (tid < CT && co0 + tid < Co) {
    float m2 = red[tid];
    for (int k = 1; k < nwg; ++k) m2 += red[k * CT + tid];
    const long long stride = (long long)N * nboxes * Co;
    const long long slot = ((long long)n * nboxes + box) * Co + co0 + tid;
    part[slot] = cnt;
    part[stride + slot] = box_mean[tid];
    part[2 * stride + slot] = m2;
  }
}

template <int CPT, bool STATS>
__global__ void F32_BOUNDS
    conv3d_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                      float* __restrict__ y, float* __restrict__ part, int N,
                      int D, int H, int W, int Ci, int Co, int BD, int CT,
                      int SL, int nbd, int nbh, int nbw, int vec) {
  extern __shared__ __align__(16) float fsm[];
  const int RP = f32_row_pitch(SL);
  const int plane = F_PH * RP;
  float* patch = fsm;                          // [a][b][c][channel]
  float* wsm = fsm + (BD + 2) * plane;         // [kd][kh][channel][kw][co]

  const int tid = threadIdx.x;
  const int nvt = 16 * BD;                     // voxel threads per Co group
  const int g = tid / nvt;                     // Co group: uniform in a warp
  const int vt = tid - g * nvt;
  const int th = vt & 7, tq = (vt >> 3) & 1, tdz = vt >> 4;

  int b = blockIdx.x;
  const int bw_i = b % nbw;
  b /= nbw;
  const int bh_i = b % nbh;
  b /= nbh;
  const int bd_i = b % nbd;
  const int n = b / nbd;
  const int d0 = bd_i * BD, h0 = bh_i * F_BH, w0 = bw_i * F_BW;
  const int co0 = blockIdx.y * CT;
  const float* xn = x + (long long)n * D * H * W * Ci;

  float acc[4][CPT];
#pragma unroll
  for (int v = 0; v < 4; ++v)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[v][j] = 0.f;

  const int nthreads = blockDim.x;
  const int pvox = (BD + 2) * F_PH * F_PW;
  const int ct4 = CT / 4;
  const int cip = (Ci + 3) & ~3;
  for (int c0 = 0; c0 < Ci; c0 += SL) {
    const int sl = min(SL, cip - c0);    // this slab's channels (the last may be short)
    const int q4 = sl / 4;
    if (c0) __syncthreads();   // every thread is done with the last slab
    // the halo patch: zero outside the volume and past Ci
    for (int e = tid; e < pvox * q4; e += nthreads) {
      const int v = e / q4, c4 = e - v * q4;
      const int a = v / (F_PH * F_PW);
      const int r = v - a * (F_PH * F_PW);
      const int bb = r / F_PW, cc = r - bb * F_PW;
      const int dd = d0 - 1 + a, hh = h0 - 1 + bb, ww = w0 - 1 + cc;
      const bool in = dd >= 0 && dd < D && hh >= 0 && hh < H && ww >= 0 &&
                      ww < W;
      const int ci = c0 + 4 * c4;
      float* dst = patch + a * plane + bb * RP + cc * SL + 4 * c4;
      const float* src = xn + (((long long)dd * H + hh) * W + ww) * Ci + ci;
      if (vec) {
        const bool ok = in && ci < Ci;
        cp_async16(dst, ok ? (const void*)src : (const void*)x, ok);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          dst[j] = (in && ci + j < Ci) ? src[j] : 0.f;
      }
    }
    // the weight slab of the Co tile, zero past Ci and Co
    for (int e = tid; e < 27 * sl * ct4; e += nthreads) {
      const int c4 = e % ct4;
      const int r = e / ct4;
      const int ci = r % sl, tap = r / sl;     // tap = (kd * 3 + kh) * 3 + kw
      const int kw = tap % 3, khd = tap / 3;
      float* dst = wsm + ((khd * SL + ci) * 3 + kw) * CT + 4 * c4;
      const int cig = c0 + ci, co = co0 + 4 * c4;
      const float* src = w + ((long long)tap * Ci + cig) * Co + co;
      if (vec) {
        const bool ok = cig < Ci && co < Co;
        cp_async16(dst, ok ? (const void*)src : (const void*)w, ok);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          dst[j] = (cig < Ci && co + j < Co) ? src[j] : 0.f;
      }
    }
    cp_async_commit();
    cp_async_wait_0();
    __syncthreads();

#ifndef CONV3D_F32_FILLS_ONLY
    const float* pbase = patch + tdz * plane + th * RP + 4 * tq * SL;
    const float* wbase = wsm + g * CPT;
#pragma unroll 1
    for (int kdh = 0; kdh < 9; ++kdh) {
      const int kd = kdh / 3, kh = kdh - 3 * kd;
      const float* pr = pbase + kd * plane + kh * RP;
      const float* wr = wbase + kdh * SL * 3 * CT;
#pragma unroll 1
      for (int c = 0; c < sl; c += 4) {
        float4 p[6];
#pragma unroll
        for (int j = 0; j < 6; ++j)
          p[j] = *reinterpret_cast<const float4*>(pr + j * SL + c);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
#pragma unroll
          for (int kw = 0; kw < 3; ++kw) {
            const float* wp = wr + ((c + k) * 3 + kw) * CT;
            float wv[CPT];
#pragma unroll
            for (int j = 0; j < CPT; j += 4) {
              const float4 t = *reinterpret_cast<const float4*>(wp + j);
              wv[j] = t.x;
              wv[j + 1] = t.y;
              wv[j + 2] = t.z;
              wv[j + 3] = t.w;
            }
#pragma unroll
            for (int v = 0; v < 4; ++v) {
              const float xv = lane_of(p[v + kw], k);
#pragma unroll
              for (int j = 0; j < CPT; ++j) acc[v][j] = fmaf(xv, wv[j], acc[v][j]);
            }
          }
        }
      }
    }
#endif
  }

  const int d = d0 + tdz, h = h0 + th;
  const int co = co0 + g * CPT;
#ifdef CONV3D_F32_NO_STORE
  if (!STATS && acc[0][0] != 12345.f) return;   // keeps the products alive
#endif
  bool ok[4];
#pragma unroll
  for (int v = 0; v < 4; ++v) ok[v] = d < D && h < H && w0 + 4 * tq + v < W;
  if (co < Co) {
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      if (!ok[v]) continue;
      const int ww = w0 + 4 * tq + v;
      float* dst = y + ((((long long)n * D + d) * H + h) * W + ww) * Co + co;
#pragma unroll
      for (int j = 0; j < CPT; j += 4) {
        if (vec) {
          if (co + j < Co)
            *reinterpret_cast<float4*>(dst + j) =
                make_float4(acc[v][j], acc[v][j + 1], acc[v][j + 2], acc[v][j + 3]);
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (co + j + i < Co) dst[j + i] = acc[v][j + i];
        }
      }
    }
  }
  if constexpr (STATS)
    f32_box_stats<CPT>(acc, ok, fsm, part, N, D, H, W, Co, BD, CT, n,
                       (bd_i * nbh + bh_i) * nbw + bw_i, nbd * nbh * nbw, d0, h0,
                       w0, co0, g, vt, tid);
}

// Dynamic shared memory up to the card's limit for every f32 instance, once per
// device: when the library loads (conv3d_f32_prepare, for the current device)
// or, for another device, at its first launch.
constexpr int F_MAX_DEVICES = 64;
bool f32_ready[F_MAX_DEVICES] = {};

cudaError_t f32_prepare_current() {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= F_MAX_DEVICES) return cudaErrorInvalidDevice;
  if (f32_ready[dev]) return cudaSuccess;
  const void* kernels[] = {
      (const void*)conv3d_f32_kernel<4, false>, (const void*)conv3d_f32_kernel<8, false>,
      (const void*)conv3d_f32_kernel<4, true>, (const void*)conv3d_f32_kernel<8, true>};
  for (const void* k : kernels) {
    err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               F_SMEM_LIMIT);
    if (err != cudaSuccess) return err;
  }
  f32_ready[dev] = true;
  return cudaSuccess;
}

// -1 for a (box depth, Co tile, slab) that no instance takes. Both instances
// take these bytes: the STATS epilogue's scratch, (box_d / 2 + 1) x co_tile
// floats, reuses the patch, which is always larger.
int f32_check(int box_d, int co_tile, int slab) {
  if (box_d != 2 && box_d != 4 && box_d != 8) return -1;
  if (co_tile < 4 || co_tile > 64 || co_tile % 4 || slab < 4 || slab % 4)
    return -1;
  const int cpt = co_tile % 8 == 0 ? 8 : 4;
  if (16 * box_d * (co_tile / cpt) > F_MAX_THREADS) return -1;
  const int bytes = f32_smem_bytes(box_d, co_tile, slab);
  return bytes <= F_SMEM_LIMIT ? bytes : -1;
}

}  // namespace

// Dynamic shared memory of the f32 instance for a box of box_d x 8 x 8
// voxels, a Co tile of co_tile channels and a Ci slab of slab channels; -1
// if no instance takes them. ops/conv.py plan_conv computes the same.
extern "C" int conv3d_f32_smem_bytes(int box_d, int co_tile, int slab) {
  return f32_check(box_d, co_tile, slab);
}

// Blocks of the f32 instance that fit on an SM at once for this plan (the
// occupancy API), or -1 for a plan no instance takes.
extern "C" int conv3d_f32_blocks_per_sm(int box_d, int co_tile, int slab) {
  const int smem = f32_check(box_d, co_tile, slab);
  if (smem < 0 || f32_prepare_current() != cudaSuccess) return -1;
  const int cpt = co_tile % 8 == 0 ? 8 : 4;
  const int threads = 16 * box_d * (co_tile / cpt);
  int n = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, cpt == 8 ? conv3d_f32_kernel<8, false> : conv3d_f32_kernel<4, false>,
      threads, smem);
  return err == cudaSuccess ? n : -1;
}

// Sets every f32 instance's shared-memory attribute on the current device; called
// once when the library is loaded, so never first inside a stream capture.
extern "C" int conv3d_f32_prepare() { return (int)f32_prepare_current(); }

namespace {

int f32_run(const void* x, const void* w, void* y, float* part, int N, int D,
            int H, int W, int Ci, int Co, int box_d, int co_tile, int slab,
            void* stream) {
  const int smem = f32_check(box_d, co_tile, slab);
  if (smem < 0 || N < 1 || D < 1 || H < 1 || W < 1 || Ci < 1 || Co < 1)
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = f32_prepare_current();
  if (err != cudaSuccess) return (int)err;
  const int nbd = (D + box_d - 1) / box_d, nbh = (H + F_BH - 1) / F_BH,
            nbw = (W + F_BW - 1) / F_BW;
  const long long boxes = (long long)N * nbd * nbh * nbw;
  const int tiles = (Co + co_tile - 1) / co_tile;
  if (boxes > 0x7FFFFFFFLL || tiles > 65535) return (int)cudaErrorInvalidValue;
  const int cpt = co_tile % 8 == 0 ? 8 : 4;
  const int threads = 16 * box_d * (co_tile / cpt);
  const int vec = Ci % 4 == 0 && Co % 4 == 0 &&
                  ((reinterpret_cast<uintptr_t>(x) |
                    reinterpret_cast<uintptr_t>(w) |
                    reinterpret_cast<uintptr_t>(y)) & 15) == 0;
  dim3 grid((unsigned)boxes, (unsigned)tiles);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xf = static_cast<const float*>(x);
  const auto* wf = static_cast<const float*>(w);
  auto* yf = static_cast<float*>(y);
  auto* kernel = part ? (cpt == 8 ? conv3d_f32_kernel<8, true> : conv3d_f32_kernel<4, true>)
                      : (cpt == 8 ? conv3d_f32_kernel<8, false> : conv3d_f32_kernel<4, false>);
  kernel<<<grid, threads, smem, s>>>(xf, wf, yf, part, N, D, H, W, Ci, Co, box_d,
                                     co_tile, slab, nbd, nbh, nbw, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// x (N,D,H,W,Ci), w (3,3,3,Ci,Co), y (N,D,H,W,Co): contiguous f32 on the
// current device. box_d, co_tile, slab: the plan (ops/conv.py plan_conv).
// Launches on `stream`; returns cudaGetLastError() (cudaErrorInvalidValue for
// a plan no instance takes).
extern "C" int conv3d_ndhwc_f32(const void* x, const void* w, void* y, int N,
                                int D, int H, int W, int Ci, int Co, int box_d,
                                int co_tile, int slab, void* stream) {
  return f32_run(x, w, y, nullptr, N, D, H, W, Ci, Co, box_d, co_tile, slab,
                 stream);
}

// The same, and the STATS epilogue: `part` is f32 (3, N, boxes, Co), boxes =
// ceil(D / box_d) * ceil(H / 8) * ceil(W / 8) of one sample, box index
// (bd * nbh + bh) * nbw + bw; part[0] the count of the box's voxels inside the
// volume, part[1] their mean, part[2] their centred sum of squares, of the f32
// values written to y. Every slot is written; y is bitwise the plain
// instance's.
extern "C" int conv3d_stats_ndhwc_f32(const void* x, const void* w, void* y,
                                      void* part, int N, int D, int H, int W,
                                      int Ci, int Co, int box_d, int co_tile,
                                      int slab, void* stream) {
  if (!part) return (int)cudaErrorInvalidValue;
  return f32_run(x, w, y, static_cast<float*>(part), N, D, H, W, Ci, Co, box_d,
                 co_tile, slab, stream);
}
