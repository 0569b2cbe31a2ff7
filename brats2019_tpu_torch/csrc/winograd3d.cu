// Winograd F(2x2x2, 3x3x3) conv3d for NDHWC volumes: the same function as
// conv3d.cu (SAME, stride 1, no bias; bf16 in, f32 accumulation, bf16 out),
// computed with 64 per-point products per 2^3 output tile instead of 27 taps
// per voxel (8/27 of the multiply-adds). Built by
// brats2019_tpu_torch/ops/_build.py with nvcc for sm_90a; called through
// ctypes from brats2019_tpu_torch/ops/winograd.py (conv3d_winograd).
//
// Replaces: brats2019_tpu/ops/pallas_winograd.py conv3d_winograd (:181,
// kernel _kernel :128). The weight transform U = (G x G x G) g runs outside
// the kernel there (an XLA einsum, :87) and here (torch, cached per weight).
//
//   y(2^3 tile) = A^T [ sum_ci  U[p, ci, co] * V[p, tile, ci] ] A,
//   V = B^T d B over the 4^3 input patch at (2t-1 .. 2t+2) per axis.
//
// What bounds it on the card: for the flagship shapes the products alone
// are tensor-core work (8/27 of the direct conv's FLOPs), but per block the
// kernel streams U for all 64 points (64/27 of the weight) from L2 for every
// 32 tiles, and the inverse transform adds 216 f32 fragment updates per 64
// products. So small-spatial deep levels (few tiles, Ci*Co large) are bound
// by U bytes, and the wide shallow levels by the FP32 pipe next to the
// tensor cores.
//
// Design (what differs from the TPU kernel, which is shaped by Mosaic):
//   * x is read NDHWC directly; the halo is zero-filled by the loader
//     (cp.async with src-size 0). No 8-phase relayout, no second shifted
//     operand, no h-blocking, no phase-major output.
//   * A block owns a brick of 2 x 4 x 4 tiles (32 tiles, a 6 x 10 x 10 voxel
//     patch shared by their overlapping 4^3 windows) times 64 output
//     channels, 8 warps as 2 (tile halves) x 4 (16-channel groups).
//   * Ci advances in chunks of 32: the raw patch chunk goes to shared memory
//     once; then for each of the 4 d-points the 16 (h, w)-points of V are
//     made in f32 registers (B^T along d, h, w) and rounded to bf16 once,
//     and each warp runs 16 x 2 WMMA m16n16k16 products against U fragments
//     read straight from global memory (U is zero-padded to Ci % 32 == 0 and
//     Co % 64 == 0 by the wrapper, so its loads need no mask).
//   * A^T is linear with entries 0/+-1: every point's partial product is
//     sign-added straight into the 8 output-phase accumulators (8 f32
//     fragments per warp), so the 64-point M tensor never exists. The f32
//     summation order differs from the TPU kernel's; acc_bf16 (a VMEM
//     economy there) is not ported.
//   * Ragged tile counts (e.g. 6 x 7 x 5 tiles) are masked at the loader
//     (zeros) and at the store; D, H, W must be even, as in the reference.
//   * No atomics, fixed order: repeat runs are bitwise equal.
//
// Probe builds, for timing only (tools/torch_conv_check.py --winograd --probe):
// -DWINOGRAD_NO_PRODUCTS leaves out the U loads and the multiplies,
// -DWINOGRAD_NO_TRANSFORMS the making of V and the A^T sign-adds.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int TD = 2, TH = 4, TW = 4;  // tiles per brick along d, h, w
constexpr int BT = TD * TH * TW;       // 32 tiles (the MMA's M)
constexpr int BN = 64;                 // output channels per block
constexpr int CK = 32;                 // input channels per chunk
constexpr int THREADS = 256;           // 8 warps: 2 along tiles x 4 along Co
constexpr int PD = 2 * TD + 2, PH = 2 * TH + 2, PW = 2 * TW + 2;
constexpr int NVOX = PD * PH * PW;     // 600 voxels of raw patch
constexpr int R_LD = CK + 8;           // raw voxel pitch in elements
constexpr int V_LD = CK + 8;           // V row pitch in elements
constexpr int RAW_ELEMS = NVOX * R_LD;
constexpr int V_ELEMS = 16 * BT * V_LD;  // the 16 points of one d-point
constexpr int PIPE_BYTES = (RAW_ELEMS + V_ELEMS) * 2;
constexpr int C_LD = BN + 4;
constexpr int EPI_BYTES = 8 * BT * C_LD * 4;
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
__device__ __forceinline__ void cp_async_wait_0() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// A^T = [[1, 1, 1, 0], [0, 1, -1, -1]]
__host__ __device__ constexpr int at_coef(int s, int i) {
  return s == 0 ? (i < 3 ? 1 : 0) : (i == 0 ? 0 : (i == 1 ? 1 : -1));
}

__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 sub2(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 add2(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

// B^T on four taps in place: (t0 - t2, t1 + t2, t2 - t1, t1 - t3)
__device__ __forceinline__ void bt4(float2& t0, float2& t1, float2& t2,
                                    float2& t3) {
  const float2 a = sub2(t0, t2), b = add2(t1, t2), c = sub2(t2, t1),
               d = sub2(t1, t3);
  t0 = a;
  t1 = b;
  t2 = c;
  t3 = d;
}

using AccFrag = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
using AFrag =
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using BFrag =
    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>;

template <bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
    winograd_kernel(const __nv_bfloat16* __restrict__ x,
                    const __nv_bfloat16* __restrict__ u,
                    __nv_bfloat16* __restrict__ y, int D, int H, int W, int Ci,
                    int Co, int CiP, int CoP, int nbd, int nbh, int nbw) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* raw = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Vs = raw + RAW_ELEMS;
  float* Cs = reinterpret_cast<float*>(smem);  // the epilogue reuses both

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp >> 2;
  const int wn = warp & 3;

  int b = blockIdx.x;
  const int bw_i = b % nbw;
  b /= nbw;
  const int bh_i = b % nbh;
  b /= nbh;
  const int bd_i = b % nbd;
  const int n = b / nbd;
  const int td0 = bd_i * TD, th0 = bh_i * TH, tw0 = bw_i * TW;
  const int d0 = 2 * td0 - 1, h0 = 2 * th0 - 1, w0 = 2 * tw0 - 1;
  const int n0 = blockIdx.y * BN;
  const __nv_bfloat16* xn = x + (long long)n * D * H * W * Ci;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  AccFrag acc[8];  // output phase sd * 4 + sh * 2 + sw
#pragma unroll
  for (int i = 0; i < 8; ++i) wmma::fill_fragment(acc[i], 0.0f);

  const int n_chunks = CiP / CK;
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    const int ci0 = chunk * CK;
    // raw patch chunk -> shared memory, halo and channel tail zero-filled
    for (int e = tid; e < NVOX * (CK / 8); e += THREADS) {
      const int v = e / (CK / 8), j = e % (CK / 8);
      const int a = v / (PH * PW);
      const int rem = v - a * (PH * PW);
      const int bb = rem / PW;
      const int c = rem - bb * PW;
      const int dd = d0 + a, hh = h0 + bb, ww = w0 + c;
      const bool ok =
          dd >= 0 && dd < D && hh >= 0 && hh < H && ww >= 0 && ww < W;
      const int ci = ci0 + j * 8;
      const long long src = (((long long)dd * H + hh) * W + ww) * Ci + ci;
      __nv_bfloat16* dst = raw + v * R_LD + j * 8;
      if (VEC) {
        const bool valid = ok && ci < Ci;
        cp_async16(dst, valid ? (const void*)(xn + src) : (const void*)x,
                   valid);
      } else {
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
          dst[jj] = (ok && ci + jj < Ci) ? xn[src + jj] : zero;
      }
    }
    cp_async_commit();
    cp_async_wait_0();
    __syncthreads();

#pragma unroll
    for (int p = 0; p < 4; ++p) {
      // V for d-point p: one (tile, channel pair) per thread and turn
#ifndef WINOGRAD_NO_TRANSFORMS
      for (int unit = tid; unit < BT * (CK / 2); unit += THREADS) {
        const int cp = unit % (CK / 2), t = unit / (CK / 2);
        const int iw = t % TW, ih = (t / TW) % TH, id = t / (TW * TH);
        const __nv_bfloat16* base =
            raw + (((2 * id) * PH + 2 * ih) * PW + 2 * iw) * R_LD + 2 * cp;
        // B^T along d picks two planes: p0 = d0 - d2, p1 = d1 + d2,
        // p2 = d2 - d1, p3 = d1 - d3
        const int a1 = (p == 0) ? 0 : (p == 2 ? 2 : 1);
        const int a2 = (p == 0) ? 2 : (p == 1 ? 2 : (p == 2 ? 1 : 3));
        float2 g[4][4];
#pragma unroll
        for (int bb = 0; bb < 4; ++bb)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float2 v1 = ld2(base + ((a1 * PH + bb) * PW + c) * R_LD);
            const float2 v2 = ld2(base + ((a2 * PH + bb) * PW + c) * R_LD);
            g[bb][c] = (p == 1) ? add2(v1, v2) : sub2(v1, v2);
          }
#pragma unroll
        for (int c = 0; c < 4; ++c) bt4(g[0][c], g[1][c], g[2][c], g[3][c]);
#pragma unroll
        for (int q = 0; q < 4; ++q) bt4(g[q][0], g[q][1], g[q][2], g[q][3]);
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            *reinterpret_cast<__nv_bfloat162*>(
                Vs + ((q * 4 + r) * BT + t) * V_LD + 2 * cp) =
                __floats2bfloat162_rn(g[q][r].x, g[q][r].y);
      }
#endif
      __syncthreads();

      // 16 points x (16 tiles x 32 ci) @ (32 ci x 16 co) per warp; the next
      // point's U fragments are fetched while this one multiplies
      const __nv_bfloat16* up =
          u + ((long long)(p * 16) * CiP + ci0) * CoP + n0 + wn * 16;
      const long long u_point = (long long)CiP * CoP;
      BFrag bf[2][2];
#ifndef WINOGRAD_NO_PRODUCTS
      wmma::load_matrix_sync(bf[0][0], up, CoP);
      wmma::load_matrix_sync(bf[0][1], up + 16LL * CoP, CoP);
#endif
#pragma unroll
      for (int qr = 0; qr < 16; ++qr) {
        const int cur = qr & 1;
        AccFrag m;
#ifdef WINOGRAD_NO_PRODUCTS
        // a value the compiler cannot fold, so the sign-adds stay
        wmma::fill_fragment(m, __bfloat162float(Vs[qr * BT * V_LD + tid]));
#else
        wmma::fill_fragment(m, 0.0f);
        if (qr + 1 < 16) {
          const __nv_bfloat16* nx = up + (qr + 1) * u_point;
          wmma::load_matrix_sync(bf[cur ^ 1][0], nx, CoP);
          wmma::load_matrix_sync(bf[cur ^ 1][1], nx + 16LL * CoP, CoP);
        }
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          AFrag af;
          wmma::load_matrix_sync(af, Vs + (qr * BT + wm * 16) * V_LD + k * 16,
                                 V_LD);
          wmma::mma_sync(m, af, bf[cur][k], m);
        }
#endif
#ifdef WINOGRAD_NO_PRODUCTS
        (void)cur;
        (void)up;
        (void)u_point;
#endif
        const int q = qr >> 2, r = qr & 3;
#ifdef WINOGRAD_NO_TRANSFORMS
        (void)q;
        (void)r;
#pragma unroll
        for (int i = 0; i < m.num_elements; ++i) acc[qr & 7].x[i] += m.x[i];
#else
#pragma unroll
        for (int sd = 0; sd < 2; ++sd)
#pragma unroll
          for (int sh = 0; sh < 2; ++sh)
#pragma unroll
            for (int sw = 0; sw < 2; ++sw) {
              const int coef = at_coef(sd, p) * at_coef(sh, q) * at_coef(sw, r);
              if (coef > 0) {
#pragma unroll
                for (int i = 0; i < m.num_elements; ++i)
                  acc[sd * 4 + sh * 2 + sw].x[i] += m.x[i];
              } else if (coef < 0) {
#pragma unroll
                for (int i = 0; i < m.num_elements; ++i)
                  acc[sd * 4 + sh * 2 + sw].x[i] -= m.x[i];
              }
            }
#endif
      }
      __syncthreads();
    }
  }

  // accumulators -> shared memory [phase][tile][co] -> bf16 NDHWC
#pragma unroll
  for (int ph = 0; ph < 8; ++ph)
    wmma::store_matrix_sync(Cs + (ph * BT + wm * 16) * C_LD + wn * 16, acc[ph],
                            C_LD, wmma::mem_row_major);
  __syncthreads();

  const int Td = D / 2, Th = H / 2, Tw = W / 2;
  __nv_bfloat16* yn = y + (long long)n * D * H * W * Co;
  for (int e = tid; e < BT * 8 * (BN / 8); e += THREADS) {
    const int cg = (e % (BN / 8)) * 8;
    const int ph = (e / (BN / 8)) % 8;
    const int t = e / (BN / 8 * 8);
    const int iw = t % TW, ih = (t / TW) % TH, id = t / (TW * TH);
    const int td = td0 + id, th = th0 + ih, tw = tw0 + iw;
    const int co = n0 + cg;
    if (td >= Td || th >= Th || tw >= Tw || co >= Co) continue;
    const int od = 2 * td + (ph >> 2), oh = 2 * th + ((ph >> 1) & 1),
              ow = 2 * tw + (ph & 1);
    const float* src = Cs + (ph * BT + t) * C_LD + cg;
    __nv_bfloat16* dst = yn + (((long long)od * H + oh) * W + ow) * Co + co;
    if (VEC) {
      __align__(16) __nv_bfloat16 v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = __float2bfloat16(src[j]);
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
    } else {
      for (int j = 0; j < 8 && co + j < Co; ++j)
        dst[j] = __float2bfloat16(src[j]);
    }
  }
}

}  // namespace

// x (N,D,H,W,Ci), y (N,D,H,W,Co): contiguous bf16 on the current device,
// D, H, W even. u (64, CiP, CoP): the transformed weight, bf16, zero-padded
// to CiP % 32 == 0 >= Ci and CoP % 64 == 0 >= Co. Launches on `stream`;
// returns cudaGetLastError() (cudaErrorInvalidValue for a bad shape).
extern "C" int winograd3d_ndhwc_bf16(const void* x, const void* u, void* y,
                                     int N, int D, int H, int W, int Ci,
                                     int Co, int CiP, int CoP, void* stream) {
  if (N < 1 || D < 2 || H < 2 || W < 2 || (D | H | W) & 1 || CiP % CK ||
      CoP % BN || CiP < Ci || CoP < Co)
    return (int)cudaErrorInvalidValue;
  const int nbd = (D / 2 + TD - 1) / TD, nbh = (H / 2 + TH - 1) / TH,
            nbw = (W / 2 + TW - 1) / TW;
  dim3 grid((unsigned)((long long)N * nbd * nbh * nbw), (unsigned)(CoP / BN));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* ub = static_cast<const __nv_bfloat16*>(u);
  auto* yb = static_cast<__nv_bfloat16*>(y);
  cudaError_t err;
  if (Ci % 8 == 0 && Co % 8 == 0) {
    static bool ready = false;  // once, outside any stream capture
    if (!ready) {
      err = cudaFuncSetAttribute(winograd_kernel<true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 SMEM_BYTES);
      if (err != cudaSuccess) return (int)err;
      ready = true;
    }
    winograd_kernel<true><<<grid, THREADS, SMEM_BYTES, s>>>(
        xb, ub, yb, D, H, W, Ci, Co, CiP, CoP, nbd, nbh, nbw);
  } else {
    static bool ready = false;  // once, outside any stream capture
    if (!ready) {
      err = cudaFuncSetAttribute(winograd_kernel<false>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 SMEM_BYTES);
      if (err != cudaSuccess) return (int)err;
      ready = true;
    }
    winograd_kernel<false><<<grid, THREADS, SMEM_BYTES, s>>>(
        xb, ub, yb, D, H, W, Ci, Co, CiP, CoP, nbd, nbh, nbw);
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The f32 instance: what a configuration with compute_dtype "float32" runs
// with the Winograd backend (the presets unit and smoke, the accuracy
// benchmark's config). The JAX package's Winograd conv computes in the dtype
// it is given, so this one does too: f32 in, f32 out, f32 U and V (never
// rounded), the 64 per-point products as FFMA on the CUDA cores (no tensor
// cores, no TF32).
//
// What bounds it on the card: the FP32 pipe (67 TFLOP/s dense on an H100
// SXM), against 8/27 of the direct conv's multiply-adds plus the transforms;
// written for correctness first.
//
// Design (the same F(2^3,3^3) as the bf16 instance above):
//   * a block owns the same brick of 2 x 4 x 4 tiles (its 6 x 10 x 10 raw
//     patch) times 64 output channels, with 256 threads; thread (tm, tn)
//     holds tiles 2 tm, 2 tm + 1 and channels 4 tn .. 4 tn + 3 of all 8
//     output phases (64 f32 accumulators);
//   * Ci advances in chunks of 16: the raw patch chunk goes to shared memory
//     with the bf16 instance's masking (halo and channel tail zero-filled,
//     ragged tiles read zeros); for each of the 4 d-points the 16 (h, w)
//     points of V are made in f32 registers (B^T along d, h, w, in the plain
//     version's order, so V is the plain version's value) into shared memory
//     as [point][channel][tile];
//   * per point, a thread sums its 2 x 4 products over the chunk's 16
//     channels (V from shared memory, U, zero-padded to CiP % 16 == 0 and
//     CoP % 64 == 0 by the wrapper, as float4 from global memory), then
//     sign-adds them into the output phases by A^T, as the bf16 instance;
//   * every output's sum runs over (chunk, d-point, point, channel) in one
//     fixed order: repeat runs are bitwise equal.

namespace {

constexpr int F_CK = 16;                 // input channels per chunk
constexpr int F_R_LD = F_CK + 1;         // raw voxel pitch in floats
constexpr int F_RAW = NVOX * F_R_LD;     // floats of raw patch
constexpr int F_V = 16 * F_CK * BT;      // floats of V: one d-point's 16 points
constexpr int F_SMEM_BYTES = (F_RAW + F_V) * 4;

__global__ void __launch_bounds__(THREADS)
    winograd_f32_kernel(const float* __restrict__ x,
                        const float* __restrict__ u, float* __restrict__ y,
                        int D, int H, int W, int Ci, int Co, int CiP, int CoP,
                        int nbd, int nbh, int nbw) {
  extern __shared__ __align__(16) float fsmem[];
  float* raw = fsmem;        // [voxel][channel], pitch F_R_LD
  float* Vs = fsmem + F_RAW; // [point][channel][tile]

  const int tid = threadIdx.x;
  const int tm = tid & 15;   // tiles 2 tm, 2 tm + 1
  const int tn = tid >> 4;   // channels 4 tn .. 4 tn + 3 of the block's 64

  int b = blockIdx.x;
  const int bw_i = b % nbw;
  b /= nbw;
  const int bh_i = b % nbh;
  b /= nbh;
  const int bd_i = b % nbd;
  const int n = b / nbd;
  const int td0 = bd_i * TD, th0 = bh_i * TH, tw0 = bw_i * TW;
  const int d0 = 2 * td0 - 1, h0 = 2 * th0 - 1, w0 = 2 * tw0 - 1;
  const int n0 = blockIdx.y * BN;
  const float* xn = x + (long long)n * D * H * W * Ci;

  float acc[8][2][4];  // [phase sd * 4 + sh * 2 + sw][tile][channel]
#pragma unroll
  for (int ph = 0; ph < 8; ++ph)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[ph][i][j] = 0.f;

  const long long u_point = (long long)CiP * CoP;
  const int n_chunks = CiP / F_CK;
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    const int ci0 = chunk * F_CK;
    // raw patch chunk -> shared memory, halo and channel tail zero-filled
    for (int e = tid; e < NVOX * F_CK; e += THREADS) {
      const int v = e / F_CK, j = e % F_CK;
      const int a = v / (PH * PW);
      const int rem = v - a * (PH * PW);
      const int bb = rem / PW;
      const int c = rem - bb * PW;
      const int dd = d0 + a, hh = h0 + bb, ww = w0 + c;
      const int ci = ci0 + j;
      const bool ok = dd >= 0 && dd < D && hh >= 0 && hh < H && ww >= 0 &&
                      ww < W && ci < Ci;
      raw[v * F_R_LD + j] =
          ok ? xn[(((long long)dd * H + hh) * W + ww) * Ci + ci] : 0.f;
    }
    __syncthreads();

#pragma unroll 1
    for (int p = 0; p < 4; ++p) {
      // V for d-point p: one (tile, channel) per thread and turn
      const int a1 = (p == 0) ? 0 : (p == 2 ? 2 : 1);
      const int a2 = (p == 0) ? 2 : (p == 1 ? 2 : (p == 2 ? 1 : 3));
      for (int unit = tid; unit < BT * F_CK; unit += THREADS) {
        const int t = unit % BT, c = unit / BT;
        const int iw = t % TW, ih = (t / TW) % TH, id = t / (TW * TH);
        const float* base =
            raw + (((2 * id) * PH + 2 * ih) * PW + 2 * iw) * F_R_LD + c;
        float g[4][4];
#pragma unroll
        for (int bb = 0; bb < 4; ++bb)
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
            const float v1 = base[((a1 * PH + bb) * PW + cc) * F_R_LD];
            const float v2 = base[((a2 * PH + bb) * PW + cc) * F_R_LD];
            g[bb][cc] = (p == 1) ? v1 + v2 : v1 - v2;
          }
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {   // B^T along h
          const float t0 = g[0][cc], t1 = g[1][cc], t2 = g[2][cc], t3 = g[3][cc];
          g[0][cc] = t0 - t2;
          g[1][cc] = t1 + t2;
          g[2][cc] = t2 - t1;
          g[3][cc] = t1 - t3;
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {      // B^T along w
          const float t0 = g[q][0], t1 = g[q][1], t2 = g[q][2], t3 = g[q][3];
          g[q][0] = t0 - t2;
          g[q][1] = t1 + t2;
          g[q][2] = t2 - t1;
          g[q][3] = t1 - t3;
        }
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            Vs[((q * 4 + r) * F_CK + c) * BT + t] = g[q][r];
      }
      __syncthreads();

      const float* up = u + ((long long)(p * 16) * CiP + ci0) * CoP + n0 + tn * 4;
#pragma unroll 1
      for (int qr = 0; qr < 16; ++qr) {
        float m[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) m[i][j] = 0.f;
        const float* vq = Vs + qr * F_CK * BT + 2 * tm;
        const float* uq = up + qr * u_point;
#pragma unroll
        for (int k = 0; k < F_CK; ++k) {
          const float2 v = *reinterpret_cast<const float2*>(vq + k * BT);
          const float4 w4 =
              __ldg(reinterpret_cast<const float4*>(uq + (long long)k * CoP));
          const float vv[2] = {v.x, v.y};
          const float uu[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) m[i][j] = fmaf(vv[i], uu[j], m[i][j]);
        }
        const int q = qr >> 2, r = qr & 3;
#pragma unroll
        for (int sd = 0; sd < 2; ++sd)
#pragma unroll
          for (int sh = 0; sh < 2; ++sh)
#pragma unroll
            for (int sw = 0; sw < 2; ++sw) {
              const int coef = at_coef(sd, p) * at_coef(sh, q) * at_coef(sw, r);
              const int ph = sd * 4 + sh * 2 + sw;
              if (coef > 0) {
#pragma unroll
                for (int i = 0; i < 2; ++i)
#pragma unroll
                  for (int j = 0; j < 4; ++j) acc[ph][i][j] += m[i][j];
              } else if (coef < 0) {
#pragma unroll
                for (int i = 0; i < 2; ++i)
#pragma unroll
                  for (int j = 0; j < 4; ++j) acc[ph][i][j] -= m[i][j];
              }
            }
      }
      __syncthreads();
    }
  }

  // accumulators -> f32 NDHWC, masked to the real tiles and to Co
  const int Td = D / 2, Th = H / 2, Tw = W / 2;
  float* yn = y + (long long)n * D * H * W * Co;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = 2 * tm + i;
    const int iw = t % TW, ih = (t / TW) % TH, id = t / (TW * TH);
    const int td = td0 + id, th = th0 + ih, tw = tw0 + iw;
    if (td >= Td || th >= Th || tw >= Tw) continue;
#pragma unroll
    for (int ph = 0; ph < 8; ++ph) {
      const int od = 2 * td + (ph >> 2), oh = 2 * th + ((ph >> 1) & 1),
                ow = 2 * tw + (ph & 1);
      float* dst = yn + (((long long)od * H + oh) * W + ow) * Co;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int co = n0 + tn * 4 + j;
        if (co < Co) dst[co] = acc[ph][i][j];
      }
    }
  }
}

}  // namespace

// x (N,D,H,W,Ci), y (N,D,H,W,Co): contiguous f32 on the current device,
// D, H, W even. u (64, CiP, CoP): the transformed weight in f32, zero-padded
// to CiP % 16 == 0 >= Ci and CoP % 64 == 0 >= Co. Launches on `stream`;
// returns cudaGetLastError() (cudaErrorInvalidValue for a bad shape).
extern "C" int winograd3d_ndhwc_f32(const void* x, const void* u, void* y,
                                    int N, int D, int H, int W, int Ci, int Co,
                                    int CiP, int CoP, void* stream) {
  if (N < 1 || D < 2 || H < 2 || W < 2 || (D | H | W) & 1 || CiP % F_CK ||
      CoP % BN || CiP < Ci || CoP < Co)
    return (int)cudaErrorInvalidValue;
  const int nbd = (D / 2 + TD - 1) / TD, nbh = (H / 2 + TH - 1) / TH,
            nbw = (W / 2 + TW - 1) / TW;
  dim3 grid((unsigned)((long long)N * nbd * nbh * nbw), (unsigned)(CoP / BN));
  static bool ready = false;  // once, outside any stream capture
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        winograd_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        F_SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    ready = true;
  }
  winograd_f32_kernel<<<grid, THREADS, F_SMEM_BYTES,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(u),
      static_cast<float*>(y), D, H, W, Ci, Co, CiP, CoP, nbd, nbh, nbw);
  return (int)cudaGetLastError();
}
