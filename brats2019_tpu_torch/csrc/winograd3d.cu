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
// SXM) for 8/27 of the direct conv's multiply-adds, plus the two transforms,
// which at the f32 configurations' channel counts (Ci 3-48, Co 4-48) cost
// as much as the products: V takes ~80 adds per (tile, channel, d-point),
// A^T 136 per (tile, output channel).
//
// Design (the F(2^3,3^3) of the bf16 instance above; the loops reordered so
// that each transform runs once):
//   * A block owns the bf16 instance's brick of 2 x 4 x 4 tiles (its
//     6 x 10 x 10 raw patch, halo zero-filled: all of Ci, filled once into
//     shared memory, or where that does not fit, each chunk of Ci filled
//     again for each d-point) and a Co tile of CT channels sized to Co (4, 8,
//     ..., 32; wider Co walks several tiles). U is padded to that tile and Ci
//     only to a multiple of 4 (ops/winograd.py padded_u).
//   * For each d-point p the block runs over Ci in chunks of VS channels (all
//     of Ci where the plan's shared memory allows): the chunk of U for p's 16
//     points goes to shared memory by 16-byte cp.async, and V for the same
//     points is made from the raw patch (B^T along d, h, w in the plain
//     version's order, so V is the plain version's value). Then each thread
//     sums its products, 4 tiles x 4 channels of one point at a time, V and
//     U read as float4s (U broadcast across the 8 lanes of a point), over
//     the whole of Ci before anything else touches them.
//   * The 16 points' sums M go to shared memory, and each thread folds the
//     M of its (tile, channel) pairs: A^T along w on the 4 w-points, then
//     the two results sign-added into the 8 output-phase accumulators by the
//     (d, h) coefficients. A^T runs once per point, not once per chunk.
//   * Every output's sum runs over (d-point, h-point, w-point, channel) in one
//     fixed order: repeat runs are bitwise equal.
//
// Probe builds, for timing only (tools/torch_conv_check.py --f32 --winograd
// --probe): -DWINOGRAD_F32_PROBE=bits leaves out the making of V (1), the
// products (2), A^T (4), keeping the fills and barriers.

#ifndef WINOGRAD_F32_PROBE
#define WINOGRAD_F32_PROBE 0
#endif

namespace {

constexpr int FW_MAX_THREADS = 512;
constexpr int FW_SMEM_LIMIT = 232448;   // dynamic shared memory a block may ask for

// 128 threads up to a Co tile of 8, then 16 a channel: each thread owns
// TPT = 32 * CT / threads (1 or 2) product tasks and as many (tile, channel)
// pairs.
__host__ __device__ constexpr int fw_threads(int ct) {
  return ct <= 8 ? 128 : 16 * ct;
}

// the raw patch [voxel][channel] of rc channels (all of CiP, or a chunk) at a
// pitch of rc + 1 floats, V [point][channel][tile] and U [point][channel][co]
// of a chunk, M [point][tile][co] of a d-point
__host__ __device__ constexpr int fw_smem_bytes(int rc, int ct, int vs) {
  return 4 * (NVOX * (rc + 1) + 16 * vs * (BT + ct) + 16 * BT * ct);
}

// channels [c0, c0 + nc) of the raw patch -> raw, pitch rld; zero outside the
// volume and past Ci. Where Ci % 4 == 0 four channels a load (nc % 4 == 0).
__device__ __forceinline__ void fill_raw(float* raw, const float* xn, int c0,
                                         int nc, int rld, int d0, int h0,
                                         int w0, int D, int H, int W, int Ci,
                                         int tid, int nthreads) {
  if (Ci % 4 == 0) {
    // four loads in flight a thread before their stores
    const int n4 = nc / 4, total = NVOX * n4;
    for (int e0 = tid; e0 < total; e0 += 4 * nthreads) {
      float4 t[4];
      int at[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int e = e0 + k * nthreads;
        const int v = e / n4, j = 4 * (e - v * n4);
        const int a = v / (PH * PW);
        const int rem = v - a * (PH * PW);
        const int bb = rem / PW;
        const int c = rem - bb * PW;
        const int dd = d0 + a, hh = h0 + bb, ww = w0 + c;
        const bool ok = e < total && dd >= 0 && dd < D && hh >= 0 && hh < H &&
                        ww >= 0 && ww < W && c0 + j < Ci;
        t[k] = ok ? __ldg(reinterpret_cast<const float4*>(
                        xn + (((long long)dd * H + hh) * W + ww) * Ci + c0 + j))
                  : make_float4(0.f, 0.f, 0.f, 0.f);
        at[k] = e < total ? v * rld + j : -1;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (at[k] < 0) continue;
        float* dst = raw + at[k];
        dst[0] = t[k].x;
        dst[1] = t[k].y;
        dst[2] = t[k].z;
        dst[3] = t[k].w;
      }
    }
    return;
  }
  for (int e = tid; e < NVOX * nc; e += nthreads) {
    const int v = e / nc, j = e - v * nc;
    const int a = v / (PH * PW);
    const int rem = v - a * (PH * PW);
    const int bb = rem / PW;
    const int c = rem - bb * PW;
    const int dd = d0 + a, hh = h0 + bb, ww = w0 + c;
    const bool ok = dd >= 0 && dd < D && hh >= 0 && hh < H && ww >= 0 &&
                    ww < W && c0 + j < Ci;
    raw[v * rld + j] =
        ok ? xn[(((long long)dd * H + hh) * W + ww) * Ci + c0 + j] : 0.f;
  }
}

// Adds the M of d-point P's 16 points (mp[(q * 4 + r) * stride]) of one
// (tile, channel) into its 8 output phases: A^T along w, then the (d, h)
// coefficients' signs.
template <int P>
__device__ __forceinline__ void at_accumulate(float (&a)[8], const float* mp,
                                              int stride) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float m0 = mp[(q * 4) * stride], m1 = mp[(q * 4 + 1) * stride],
                m2 = mp[(q * 4 + 2) * stride], m3 = mp[(q * 4 + 3) * stride];
    const float w0 = (m0 + m1) + m2, w1 = (m1 - m2) - m3;
#pragma unroll
    for (int sd = 0; sd < 2; ++sd)
#pragma unroll
      for (int sh = 0; sh < 2; ++sh) {
        const int coef = at_coef(sd, P) * at_coef(sh, q);
        const int ph = sd * 4 + sh * 2;
        if (coef > 0) {
          a[ph] += w0;
          a[ph + 1] += w1;
        } else if (coef < 0) {
          a[ph] -= w0;
          a[ph + 1] -= w1;
        }
      }
  }
}

template <int TPT>
__global__ void __launch_bounds__(FW_MAX_THREADS)
    winograd_f32_kernel(const float* __restrict__ x,
                        const float* __restrict__ u, float* __restrict__ y,
                        int D, int H, int W, int Ci, int Co, int CiP, int CoP,
                        int CT, int VS, int RC, int nbd, int nbh, int nbw) {
  extern __shared__ __align__(16) float fsmem[];
  const bool resident = RC >= CiP;   // else RC == VS: a chunk at a time
  const int RLD = RC + 1;
  float* raw = fsmem;                 // [voxel][channel], pitch RLD
  float* Vs = raw + NVOX * RLD;       // [point][channel][tile], a chunk
  float* Us = Vs + 16 * VS * BT;      // [point][channel][co], a chunk
  float* Ms = Us + 16 * VS * CT;      // [point][tile][co], a d-point

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;

  int b = blockIdx.x;
  const int bw_i = b % nbw;
  b /= nbw;
  const int bh_i = b % nbh;
  b /= nbh;
  const int bd_i = b % nbd;
  const int n = b / nbd;
  const int td0 = bd_i * TD, th0 = bh_i * TH, tw0 = bw_i * TW;
  const int d0 = 2 * td0 - 1, h0 = 2 * th0 - 1, w0 = 2 * tw0 - 1;
  const int co0 = blockIdx.y * CT;
  const float* xn = x + (long long)n * D * H * W * Ci;

  // the raw patch (ragged tiles read zeros), all of Ci where it is resident
  if (resident)
    fill_raw(raw, xn, 0, CiP, RLD, d0, h0, w0, D, H, W, Ci, tid, nthreads);

  const int cq4 = CT / 4;
  float acc[TPT][8];  // [pair][phase sd * 4 + sh * 2 + sw]
#pragma unroll
  for (int k = 0; k < TPT; ++k)
#pragma unroll
    for (int ph = 0; ph < 8; ++ph) acc[k][ph] = 0.f;

#pragma unroll 1
  for (int p = 0; p < 4; ++p) {
    float m[TPT][4][4];  // [task][tile][channel]: sums over Ci of one point
#pragma unroll
    for (int k = 0; k < TPT; ++k)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) m[k][i][j] = 0.f;
    const int a1 = (p == 0) ? 0 : (p == 2 ? 2 : 1);
    const int a2 = (p == 0) ? 2 : (p == 1 ? 2 : (p == 2 ? 1 : 3));

#pragma unroll 1
    for (int cs = 0; cs < CiP; cs += VS) {
      const int vs = min(VS, CiP - cs);
      __syncthreads();  // the raw patch is in; the last chunk has been read
      // U of p's 16 points for this chunk (U is padded: always in bounds)
      for (int e = tid; e < 16 * vs * cq4; e += nthreads) {
        const int c4 = e % cq4;
        const int r = e / cq4;
        const int ci = r % vs, pt = r / vs;
        cp_async16(Us + (pt * VS + ci) * CT + 4 * c4,
                   u + ((long long)(p * 16 + pt) * CiP + cs + ci) * CoP + co0 +
                       4 * c4,
                   true);
      }
      cp_async_commit();
      if (!resident) {
        fill_raw(raw, xn, cs, vs, RLD, d0, h0, w0, D, H, W, Ci, tid, nthreads);
        __syncthreads();
      }
      const int rc0 = resident ? cs : 0;   // the chunk's first channel in raw
      // V of p's 16 points: one (tile, channel) per thread and turn
#if !(WINOGRAD_F32_PROBE & 1)
      for (int unit = tid; unit < BT * vs; unit += nthreads) {
        const int t = unit % BT, c = unit / BT;
        const int iw = t % TW, ih = (t / TW) % TH, id = t / (TW * TH);
        const float* base =
            raw + (((2 * id) * PH + 2 * ih) * PW + 2 * iw) * RLD + rc0 + c;
        float g[4][4];
#pragma unroll
        for (int bb = 0; bb < 4; ++bb)
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
            const float v1 = base[((a1 * PH + bb) * PW + cc) * RLD];
            const float v2 = base[((a2 * PH + bb) * PW + cc) * RLD];
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
            Vs[((q * 4 + r) * VS + c) * BT + t] = g[q][r];
      }
#endif
      cp_async_wait_0();
      __syncthreads();

      // products: task = (point, 4 tiles, 4 channels)
#if !(WINOGRAD_F32_PROBE & 2)
#pragma unroll
      for (int k = 0; k < TPT; ++k) {
        const int task = tid + k * nthreads;
        const int tq = task & 7;
        const int r = task >> 3;
        const int cq = r % cq4, pt = r / cq4;
        const float* vp = Vs + pt * VS * BT + 4 * tq;
        const float* up = Us + pt * VS * CT + 4 * cq;
#pragma unroll 4
        for (int ci = 0; ci < vs; ++ci) {
          const float4 v = *reinterpret_cast<const float4*>(vp + ci * BT);
          const float4 w4 = *reinterpret_cast<const float4*>(up + ci * CT);
          const float vv[4] = {v.x, v.y, v.z, v.w};
          const float uu[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) m[k][i][j] = fmaf(vv[i], uu[j], m[k][i][j]);
        }
      }
#endif
    }

    // M of p's 16 points, then A^T once per point
#pragma unroll
    for (int k = 0; k < TPT; ++k) {
      const int task = tid + k * nthreads;
      const int tq = task & 7;
      const int r = task >> 3;
      const int cq = r % cq4, pt = r / cq4;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        *reinterpret_cast<float4*>(Ms + (pt * BT + 4 * tq + i) * CT + 4 * cq) =
            make_float4(m[k][i][0], m[k][i][1], m[k][i][2], m[k][i][3]);
    }
    __syncthreads();
#if !(WINOGRAD_F32_PROBE & 4)
#pragma unroll
    for (int k = 0; k < TPT; ++k) {
      const int pair = tid + k * nthreads;
      const float* mp = Ms + pair;   // (tile, co) = (pair / CT, pair % CT)
      switch (p) {
        case 0: at_accumulate<0>(acc[k], mp, BT * CT); break;
        case 1: at_accumulate<1>(acc[k], mp, BT * CT); break;
        case 2: at_accumulate<2>(acc[k], mp, BT * CT); break;
        default: at_accumulate<3>(acc[k], mp, BT * CT); break;
      }
    }
#endif
  }

  // accumulators -> f32 NDHWC, masked to the real tiles and to Co
  const int Td = D / 2, Th = H / 2, Tw = W / 2;
  float* yn = y + (long long)n * D * H * W * Co;
#pragma unroll
  for (int k = 0; k < TPT; ++k) {
    const int pair = tid + k * nthreads;
    const int t = pair / CT, co = co0 + pair % CT;
    const int iw = t % TW, ih = (t / TW) % TH, id = t / (TW * TH);
    const int td = td0 + id, th = th0 + ih, tw = tw0 + iw;
    if (co >= Co || td >= Td || th >= Th || tw >= Tw) continue;
#pragma unroll
    for (int ph = 0; ph < 8; ++ph) {
      const int od = 2 * td + (ph >> 2), oh = 2 * th + ((ph >> 1) & 1),
                ow = 2 * tw + (ph & 1);
      yn[(((long long)od * H + oh) * W + ow) * Co + co] = acc[k][ph];
    }
  }
}

// Dynamic shared memory up to the card's limit for both instances, once per
// device: when the library loads (winograd3d_f32_prepare, for the current
// device) or, for another device, at its first launch.
constexpr int FW_MAX_DEVICES = 64;
bool fw_ready[FW_MAX_DEVICES] = {};

cudaError_t fw_prepare_current() {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= FW_MAX_DEVICES) return cudaErrorInvalidDevice;
  if (fw_ready[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(winograd_f32_kernel<1>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             FW_SMEM_LIMIT);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(winograd_f32_kernel<2>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               FW_SMEM_LIMIT);
  if (err == cudaSuccess) fw_ready[dev] = true;
  return err;
}

// -1 for a (raw channels, Co tile, chunk) that no instance takes: the raw
// patch holds all of Ci padded (rc >= chunk) or one chunk (rc == chunk)
int fw_check(int rc, int ct, int vs) {
  if (rc < 4 || rc % 4 || ct < 4 || ct > 32 || ct % 4 || vs < 4 || vs % 4 ||
      vs > rc)
    return -1;
  const int bytes = fw_smem_bytes(rc, ct, vs);
  return bytes <= FW_SMEM_LIMIT ? bytes : -1;
}

}  // namespace

// Dynamic shared memory of the f32 instance for a raw patch of raw_channels
// channels (Ci padded, or one chunk), a Co tile of co_tile channels and
// chunks of `chunk` channels; -1 if no instance takes them. ops/winograd.py
// instance_plan computes the same.
extern "C" int winograd3d_f32_smem_bytes(int raw_channels, int co_tile,
                                         int chunk) {
  return fw_check(raw_channels, co_tile, chunk);
}

// Sets both instances' shared-memory attribute on the current device; called
// once when the library is loaded, so never first inside a stream capture.
extern "C" int winograd3d_f32_prepare() { return (int)fw_prepare_current(); }

// x (N,D,H,W,Ci), y (N,D,H,W,Co): contiguous f32 on the current device,
// D, H, W even. u (64, CiP, CoP): the transformed weight in f32, zero-padded
// to CiP = Ci rounded up to 4 and CoP a multiple of co_tile >= Co. co_tile,
// chunk, raw_channels (CiP, or chunk where the whole raw patch does not
// fit): the plan (ops/winograd.py plan_winograd). Launches on `stream`;
// returns cudaGetLastError() (cudaErrorInvalidValue for a bad shape or plan).
extern "C" int winograd3d_ndhwc_f32(const void* x, const void* u, void* y,
                                    int N, int D, int H, int W, int Ci, int Co,
                                    int CiP, int CoP, int co_tile, int chunk,
                                    int raw_channels, void* stream) {
  const int smem = fw_check(raw_channels, co_tile, chunk);
  if (smem < 0 || (raw_channels != CiP && raw_channels != chunk) ||
      chunk > CiP || N < 1 || D < 2 || H < 2 || W < 2 || (D | H | W) & 1 ||
      Ci < 1 || Co < 1 || CiP < Ci || CiP >= Ci + 4 || CoP < Co ||
      CoP % co_tile || (reinterpret_cast<uintptr_t>(u) & 15))
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = fw_prepare_current();
  if (err != cudaSuccess) return (int)err;
  const int nbd = (D / 2 + TD - 1) / TD, nbh = (H / 2 + TH - 1) / TH,
            nbw = (W / 2 + TW - 1) / TW;
  const long long bricks = (long long)N * nbd * nbh * nbw;
  if (bricks > 0x7FFFFFFFLL || CoP / co_tile > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)bricks, (unsigned)(CoP / co_tile));
  const int threads = fw_threads(co_tile);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xf = static_cast<const float*>(x);
  const auto* uf = static_cast<const float*>(u);
  auto* yf = static_cast<float*>(y);
  if (32 * co_tile / threads == 1)
    winograd_f32_kernel<1><<<grid, threads, smem, s>>>(
        xf, uf, yf, D, H, W, Ci, Co, CiP, CoP, co_tile, chunk, raw_channels,
        nbd, nbh, nbw);
  else
    winograd_f32_kernel<2><<<grid, threads, smem, s>>>(
        xf, uf, yf, D, H, W, Ci, Co, CiP, CoP, co_tile, chunk, raw_channels,
        nbd, nbh, nbw);
  return (int)cudaGetLastError();
}
