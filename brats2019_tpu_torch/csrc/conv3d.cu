// SAME stride-1 3x3x3 conv3d for NDHWC volumes, no bias, in two instances:
// bf16 in, f32 accumulation, bf16 out (conv3d_ndhwc_bf16, tensor cores), and
// f32 in, f32 FFMA accumulation, f32 out (conv3d_ndhwc_f32, at the end of
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
// against 4 + 4 bytes, far above the f32 ridge (~20 flop/byte).
//
// Design, written for correctness first (the same implicit GEMM and masked
// halo as the bf16 instance above, without tensor cores or cp.async):
//   * a block computes a 64-voxel x 64-channel output tile with 256 threads,
//     each thread a 4 x 4 register tile (4 voxels x 4 channels);
//   * K advances one (tap, 16-channel chunk) at a time: the A chunk (64
//     voxels x 16 channels, masked to zero outside the volume and past Ci)
//     is stored transposed in shared memory so a thread reads its 4 voxels
//     as one float4, the B chunk (16 x 64 of the DHWIO weight) as it lies;
//   * the sum of each output runs over (tap, chunk, channel) in one fixed
//     order: repeat runs are bitwise equal.

namespace {

constexpr int F_BM = 64;        // output voxels per block
constexpr int F_BN = 64;        // output channels per block
constexpr int F_BK = 16;        // contraction chunk: 16 channels of one tap
constexpr int F_THREADS = 256;  // 16 x 16 threads of 4 x 4 outputs
constexpr int F_LD = F_BM + 4;  // shared row pitch (float4-aligned)

__global__ void __launch_bounds__(F_THREADS)
    conv3d_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                      float* __restrict__ y, int N, int D, int H, int W,
                      int Ci, int Co) {
  __shared__ __align__(16) float As[F_BK][F_LD];   // [channel][voxel]
  __shared__ __align__(16) float Bs[F_BK][F_LD];   // [channel][out channel]

  const int tid = threadIdx.x;
  const int tm = tid & 15;          // voxels tm*4 .. tm*4+3 of the tile
  const int tn = tid >> 4;          // channels tn*4 .. tn*4+3 of the tile
  const long long M = (long long)N * D * H * W;
  const long long m0 = (long long)blockIdx.x * F_BM;
  const int n0 = blockIdx.y * F_BN;
  const long long HW = (long long)H * W;

  // A loader: voxel row a_row, channels a_col .. a_col+3 of each chunk
  const int a_row = tid >> 2;
  const int a_col = (tid & 3) * 4;
  const long long am = m0 + a_row;
  const bool a_in = am < M;
  const long long amm = a_in ? am : 0;
  const int a_w = (int)(amm % W);
  const int a_h = (int)((amm / W) % H);
  const int a_d = (int)((amm / HW) % D);
  // B loader: weight row b_row of the chunk, out channels b_col .. b_col+3
  const int b_row = tid >> 4;
  const int b_col = (tid & 15) * 4;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int n_ci_chunks = (Ci + F_BK - 1) / F_BK;
  for (int tap = 0; tap < 27; ++tap) {
    const int kd = tap / 9, kh = (tap / 3) % 3, kw = tap % 3;
    const int dd = a_d + kd - 1, hh = a_h + kh - 1, ww = a_w + kw - 1;
    const bool ok = a_in && dd >= 0 && dd < D && hh >= 0 && hh < H &&
                    ww >= 0 && ww < W;
    const long long shift = (kd - 1) * HW + (long long)(kh - 1) * W + (kw - 1);
    const float* xs = x + (amm + shift) * Ci;
    for (int cc = 0; cc < n_ci_chunks; ++cc) {
      const int ci0 = cc * F_BK;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ci = ci0 + a_col + j;
        As[a_col + j][a_row] = (ok && ci < Ci) ? xs[ci] : 0.f;
      }
      const int k = ci0 + b_row;
      const float* wsrc = w + ((long long)tap * Ci + k) * Co + n0 + b_col;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Bs[b_row][b_col + j] =
            (k < Ci && n0 + b_col + j < Co) ? wsrc[j] : 0.f;
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < F_BK; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(&As[kk][tm * 4]);
        const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tn * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + tm * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = n0 + tn * 4 + j;
      if (co < Co) y[m * Co + co] = acc[i][j];
    }
  }
}

}  // namespace

// x (N,D,H,W,Ci), w (3,3,3,Ci,Co), y (N,D,H,W,Co): contiguous f32 on the
// current device. Launches on `stream`; returns cudaGetLastError().
extern "C" int conv3d_ndhwc_f32(const void* x, const void* w, void* y, int N,
                                int D, int H, int W, int Ci, int Co,
                                void* stream) {
  const long long M = (long long)N * D * H * W;
  dim3 grid((unsigned)((M + F_BM - 1) / F_BM), (unsigned)((Co + F_BN - 1) / F_BN));
  conv3d_f32_kernel<<<grid, F_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<float*>(y), N, D, H, W, Ci, Co);
  return (int)cudaGetLastError();
}
