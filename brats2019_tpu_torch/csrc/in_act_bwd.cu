// Backward of the fused InstanceNorm3d + activation on Hopper, NDHWC bf16 or
// f32: dx (in x's type) and f32 dgamma, dbeta, in ONE persistent launch.
// Built by brats2019_tpu_torch/ops/_build.py with nvcc -gencode
// arch=compute_90a,code=sm_90a; called through ctypes from
// brats2019_tpu_torch/ops/norm.py (instance_norm_act_bwd_kernel).
//
// Replaces: brats2019_tpu/ops/pallas_norm.py _bwd_pallas (:265, kernel
// _bwd_kernel :225). Per (n, c), over the S voxels of a sample:
//   xhat = (x - mean) * rstd, y_pre = xhat * gamma + beta,
//   ga = act'(y_pre) * g      (relu: y_pre > 0; leaky: 0.01 where y_pre <= 0),
//   s1 = sum ga, s2 = sum ga * xhat,
//   dx = gamma * rstd * (ga - s1 / S - xhat * s2 / S),
//   dbeta = sum_n s1, dgamma = sum_n s2.
//
// What bounds it on the card: device-memory bytes (x and g read once, dx
// written once: 6 bytes a value in bf16, 12 in f32; ~14 flops a value). What
// held the Triton form (ops/triton_norm.py: partial pass, merge, dx pass) was
// (a) x and g read twice, 5 passes over the activation where the bound counts
// 3, (b) too few bytes in flight at batch 1 (128 programs of 4 warps, scalar
// loads over at most 64 columns) and (c) three launches with a serial merge
// between them, which is all there is at the deep levels. The design:
//
//   * One launch of a grid that is co-resident by construction: at most one
//     block of <= 512 threads per SM (the wrapper's plan, ops/norm.py
//     plan_in_bwd), launched cooperatively, so the grid barrier below cannot
//     deadlock; the entry point checks the fit with the occupancy API. The
//     samples' voxels are cut into `bps` block-contiguous ranges each, so
//     batch 1 fills every SM.
//   * Every thread moves 16 bytes at a time: a vector of E channels, 8 bf16
//     (C % 8 == 0) or 4 f32 (C % 4 == 0; unpacking and packing are plain
//     moves). The block's thread count is a multiple of C/E, so each thread
//     keeps the same E channels over its whole range and folds them into 2E
//     f32 registers. The two types share the code (template on the element
//     type, Vec<T>); the math is f32 in one order in both.
//   * Phase 1. The block starts cp.async copies of the first `keep` 16-byte
//     vectors of its x and g range into shared memory (up to ~210 KB, all in
//     flight at once), folds the rest of the range from registers (4 loads
//     of each in flight per thread) while those land, then folds the part it
//     holds. L2 hints: the part it does not hold is read with evict_last,
//     all else (the held part, the re-read, dx) with evict_first, so that
//     part is still in L2 when phase 2 reads it again. The per-thread sums
//     are reduced over the block through shared memory in one fixed order
//     and written as the block's partials (s1, s2) per (n, c). No float
//     atomics anywhere.
//   * A grid barrier on a counter in device memory (arrive, last arrival
//     bumps a generation, the others wait for it; a wait longer than 20 s
//     traps).
//   * Phase 2. Every warp of the grid takes some of the N x 2C columns and
//     sums that column's `bps` partials in one fixed order (32 lanes, then a
//     butterfly), so no block walks all the partials of its sample; a second
//     grid barrier; then each block reads its sample's sums, writes dx for
//     the part of its range that did not fit in shared memory (re-read from
//     device memory while it may still sit in L2) and then for the part it
//     holds. Block 0 writes dgamma and dbeta, summed over n in order.
//     Results are bitwise repeatable. (Every block merging its own sample's
//     partials after one barrier was measured and lost: 132 blocks reading
//     the same few L2 lines cost more than the second barrier, 23.5 against
//     11.7 us at f32 (1,32^3,16) on an H100 80GB HBM3 at 700 W.)
//   * Where all N samples together have few voxels (the deepest level), the
//     launch, two grid barriers and the merge cost more than the bytes:
//     there a second form (in_act_bwd_column_kernel, up to 4096 voxels; the
//     plan chooses where) gives each E-channel column one block of its own
//     that holds the column of every sample in shared memory and needs no
//     barrier between blocks. At 4096 voxels its C/8 blocks read slower than
//     the grid form's 132 (bf16 1,16^3,256: 15.4 against 14.2 us on an H100
//     80GB HBM3 at 700 W).
//   * A third form for one sample (f32's plans between those two;
//     in_act_bwd_cluster_kernel): a thread-block cluster of K <= 16 blocks
//     per group of W vectors, each block holding S / K voxels of its group
//     in shared memory. The blocks' partials are merged through distributed
//     shared memory after the cluster's hardware barrier, in the grid
//     merge's order (lane q takes block q, then the butterfly), so the form
//     needs no cooperative launch, no barrier counters (no memset before
//     it) and no grid-wide barrier. The fixed cost is what kept the grid
//     form above the three Triton launches at f32's small levels (11.7
//     against 7.9 us at (1,32^3,16): the memset 0.9 us, each grid barrier
//     ~1.7 us).
//   * The block reduction of f32 (few channels, so many rows of threads
//     share each channel: 256 rows at C = 8) sums within each warp by a
//     butterfly over the lanes that share channels (where C / 4 divides
//     16), then the warps, in a fixed order (one thread a channel walking
//     every row took 2.4 us at C = 8); bf16 keeps one thread a channel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 512;
constexpr int MAX_CLUSTER = 16;     // blocks of a cluster (non-portable above 8)
constexpr unsigned long long WAIT_LIMIT_NS = 20ull * 1000 * 1000 * 1000;

// L2 eviction priorities: the part of x and g a block does not hold in
// shared memory is read again in phase 2, so phase 1 reads it with
// evict_last and everything else goes with evict_first (the held part, the
// re-read, dx), to keep the re-read in L2 where it fits.
__device__ __forceinline__ uint64_t l2_policy_last() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}

__device__ __forceinline__ uint64_t l2_policy_first() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           uint64_t pol) {
  asm volatile("cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;\n"
               ::"r"(dst), "l"(src), "l"(pol)
               : "memory");
}

// A 16-byte vector of channels: 8 bf16 or 4 f32, unpacked to and packed
// from f32.
template <typename T>
struct Vec;

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int E = 8;
  static __device__ __forceinline__ void unpack(const uint4& u, float (&f)[E]) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      f[2 * k] = __uint_as_float(w[k] << 16);
      f[2 * k + 1] = __uint_as_float(w[k] & 0xFFFF0000u);
    }
  }
  static __device__ __forceinline__ uint4 pack(const float (&f)[E]) {
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      __nv_bfloat162 p = __floats2bfloat162_rn(f[2 * k], f[2 * k + 1]);
      w[k] = *reinterpret_cast<uint32_t*>(&p);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

template <>
struct Vec<float> {
  static constexpr int E = 4;
  static __device__ __forceinline__ void unpack(const uint4& u, float (&f)[E]) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  static __device__ __forceinline__ uint4 pack(const float (&f)[E]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

__device__ __forceinline__ uint4 ldg_nc(const uint4* p, uint64_t pol) {
  uint4 v;
  asm volatile("ld.global.nc.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p), "l"(pol));
  return v;
}

__device__ __forceinline__ void stg(uint4* p, const uint4& v, uint64_t pol) {
  asm volatile("st.global.L2::cache_hint.v4.u32 [%0], {%1, %2, %3, %4}, %5;\n"
               ::"l"(p), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "l"(pol)
               : "memory");
}

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// act'(y_pre) * g, as pallas_norm._act_grad (:118-123)
template <int ACT>
__device__ __forceinline__ float act_grad(float y_pre, float g) {
  if (ACT == 1) return y_pre > 0.f ? g : 0.f;
  if (ACT == 2) return y_pre > 0.f ? g : g * 0.01f;
  return g;
}

// Per-thread constants of its E channels.
template <int E>
struct Chan {
  float mean[E], rstd[E], gam[E], bet[E];
};

template <typename T, int ACT>
__device__ __forceinline__ void fold(const uint4& xv, const uint4& gv,
                                     const Chan<Vec<T>::E>& ch,
                                     float (&a1)[Vec<T>::E],
                                     float (&a2)[Vec<T>::E]) {
  constexpr int E = Vec<T>::E;
  float x[E], g[E];
  Vec<T>::unpack(xv, x);
  Vec<T>::unpack(gv, g);
#pragma unroll
  for (int k = 0; k < E; ++k) {
    const float xh = (x[k] - ch.mean[k]) * ch.rstd[k];
    const float ga = act_grad<ACT>(xh * ch.gam[k] + ch.bet[k], g[k]);
    a1[k] += ga;
    a2[k] += ga * xh;
  }
}

template <typename T, int ACT>
__device__ __forceinline__ uint4 dx_vec(const uint4& xv, const uint4& gv,
                                        const Chan<Vec<T>::E>& ch,
                                        const float (&m1)[Vec<T>::E],
                                        const float (&m2)[Vec<T>::E]) {
  constexpr int E = Vec<T>::E;
  float x[E], g[E], o[E];
  Vec<T>::unpack(xv, x);
  Vec<T>::unpack(gv, g);
#pragma unroll
  for (int k = 0; k < E; ++k) {
    const float xh = (x[k] - ch.mean[k]) * ch.rstd[k];
    const float ga = act_grad<ACT>(xh * ch.gam[k] + ch.bet[k], g[k]);
    o[k] = (ch.gam[k] * ch.rstd[k]) * (ga - m1[k] - xh * m2[k]);
  }
  return Vec<T>::pack(o);
}

// Arrive and wait for every block of the grid. bar[0] counts arrivals,
// bar[1] is the generation the last arrival bumps; the last arrival also
// sets the arrivals back to 0, so one launch can pass the barrier again.
// SC: full fences around the arrival (bf16's form); else the arrival is an
// acq_rel atomic, the generation bumped by a release and awaited by acquire
// loads, which order the same writes without the fences (f32's form; the
// probe macro IN_ACT_BWD_SC_BARRIER gives f32 the fenced one, to time both).
template <bool SC>
__device__ __forceinline__ void grid_barrier(unsigned int* bar,
                                             unsigned int nblocks) {
  // the block's writes are ordered before thread 0's fence (or release) by
  // the bar.sync, and both are cumulative (as cooperative groups' grid sync
  // has it)
  __syncthreads();
  if (threadIdx.x == 0) {
    if (SC) {
      volatile unsigned int* gen = bar + 1;
      const unsigned int g0 = *gen;
      __threadfence();
      if (atomicAdd(bar, 1u) == nblocks - 1) {
        atomicExch(bar, 0u);
        __threadfence();
        atomicAdd(bar + 1, 1u);
      } else {
        const unsigned long long t0 = globaltimer();
        while (*gen == g0) {
          __nanosleep(64);
          if (globaltimer() - t0 > WAIT_LIMIT_NS) __trap();
        }
      }
      __threadfence();
    } else {
      unsigned int g0, old;
      asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];\n" : "=r"(g0) : "l"(bar + 1) : "memory");
      asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\n"
                   : "=r"(old) : "l"(bar) : "memory");
      if (old == nblocks - 1) {
        asm volatile("st.relaxed.gpu.global.u32 [%0], 0;\n" ::"l"(bar) : "memory");
        asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(bar + 1) : "memory");
      } else {
        const unsigned long long t0 = globaltimer();
        unsigned int g;
        for (;;) {
          asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(g) : "l"(bar + 1) : "memory");
          if (g != g0) break;
          __nanosleep(32);
          if (globaltimer() - t0 > WAIT_LIMIT_NS) __trap();
        }
      }
    }
  }
  __syncthreads();
}

// The sum over the bps partials of sample n, column j of 2C (s1 then s2),
// in the one order the plain version repeats: lane q of a warp takes r = q,
// q + 32, ... in turn (the loads issued together), then a butterfly over the
// 32 lanes, adjacent pairs first.
__device__ __forceinline__ float merge_column(const float* part, int n, int j,
                                              int C, int bps, int N, int q) {
  const int which = j >= C, c = j - which * C;
  const float* p = part + ((long long)(which * N + n) * bps) * C + c;
  float s = 0.f;
  for (int r0 = q; r0 < bps; r0 += 8 * 32) {
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int r = r0 + 32 * u;
      v[u] = r < bps ? __ldcg(p + (long long)r * C) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (r0 + 32 * u < bps) s += v[u];
  }
#pragma unroll
  for (int m = 1; m < 32; m <<= 1) s += __shfl_xor_sync(0xFFFFFFFFu, s, m);
  return s;
}

// The block's sums of a1 (pass 0) and a2 (pass 1) over its rows of threads,
// channel by channel (CB channels a row, the thread's E at cv * E), in a
// fixed order, into out[pass * stride + c]. red: rows x CB floats of shared
// memory. f32 (E = 4: few channels, so many rows) where the CV = CB / 4
// vectors of a row divide 16: lanes l and l ^ m (m a multiple of CV) share
// channels, so a butterfly over those lanes sums the warp's rows of both
// passes at once, then one thread a (pass, channel) walks the warps in
// order. Else (bf16, and f32's other C) one thread a channel walks the rows
// in order.
template <int E>
__device__ __forceinline__ void block_reduce(float* red, const float (&a1)[E],
                                             const float (&a2)[E], int row,
                                             int cv, int rows, int CB,
                                             float* out, long long stride) {
  const int T_ = blockDim.x, t = threadIdx.x;
  const int CV = CB / E;
  if (E == 4 && 16 % CV == 0 && T_ % 32 == 0) {
    float v[2 * E];
#pragma unroll
    for (int k = 0; k < E; ++k) v[k] = a1[k], v[E + k] = a2[k];
    for (int m = CV; m < 32; m <<= 1)
#pragma unroll
      for (int k = 0; k < 2 * E; ++k) v[k] += __shfl_xor_sync(0xFFFFFFFFu, v[k], m);
    const int nwarps = T_ / 32, wp = t / 32, lane = t % 32;
    __syncthreads();
    if (lane < CV)
#pragma unroll
      for (int k = 0; k < E; ++k) {
        red[(wp * 2) * CB + lane * E + k] = v[k];
        red[(wp * 2 + 1) * CB + lane * E + k] = v[E + k];
      }
    __syncthreads();
    for (int j = t; j < 2 * CB; j += T_) {
      const int pass = j / CB, c = j - pass * CB;
      float s = 0.f;
      for (int q = 0; q < nwarps; ++q) s += red[(q * 2 + pass) * CB + c];
      out[pass * stride + c] = s;
    }
    return;
  }
  for (int pass = 0; pass < 2; ++pass) {
    __syncthreads();
#pragma unroll
    for (int k = 0; k < E; ++k)
      red[(row * CV + cv) * E + k] = pass == 0 ? a1[k] : a2[k];
    __syncthreads();
    for (int c = t; c < CB; c += T_) {
      float s = 0.f;
      for (int i = 0; i < rows; ++i) s += red[i * CB + c];
      out[pass * stride + c] = s;
    }
  }
}

template <typename T, int ACT>
__global__ void __launch_bounds__(MAX_THREADS, 1)
    in_act_bwd_kernel(const uint4* __restrict__ x, const uint4* __restrict__ g,
                      uint4* __restrict__ dx, const float* __restrict__ mean,
                      const float* __restrict__ rstd,
                      const float* __restrict__ gamma,
                      const float* __restrict__ beta, float* part,
                      float* __restrict__ dgamma, float* __restrict__ dbeta,
                      unsigned int* bar, int N, long long S, int C, int bps,
                      int keep) {
  constexpr int E = Vec<T>::E;
#ifdef IN_ACT_BWD_SC_BARRIER
  constexpr bool SC = true;
#else
  constexpr bool SC = E == 8;   // bf16 keeps the fenced barrier
#endif
  extern __shared__ __align__(16) uint4 smem[];
  // probe builds (tools/torch_bwd_check.py --time): -DIN_ACT_BWD_PROBE=k
  // stops after step k: 0 the launch and one grid barrier alone, 1 phase 1's
  // loads and folds, 2 the block reduction, 3 the first barrier, 4 the
  // column merge and the second barrier
#if defined(IN_ACT_BWD_PROBE) && IN_ACT_BWD_PROBE == 0
  grid_barrier<SC>(bar, gridDim.x);
  return;
#endif
  const int T_ = blockDim.x, t = threadIdx.x;
  const int CV = C / E, rows = T_ / CV;
  const int n = blockIdx.x / bps, r = blockIdx.x % bps;
  // the block's voxel range [v0, v1) of sample n, as 16-byte vectors
  const long long v0 = S * r / bps, v1 = S * (r + 1) / bps;
  const long long base = ((long long)n * S + v0) * CV;
  const long long Q = (v1 - v0) * CV;
  const int K = (int)(Q < keep ? Q : keep);
  uint4* xs = smem;
  uint4* gs = smem + keep;
  float* red = reinterpret_cast<float*>(smem + 2 * keep);  // rows x CV x E

  const int cv = t % CV, row = t / CV;
  Chan<E> ch;
#pragma unroll
  for (int k = 0; k < E; ++k) {
    const int c = cv * E + k;
    ch.mean[k] = mean[n * C + c];
    ch.rstd[k] = rstd[n * C + c];
    ch.gam[k] = gamma[c];
    ch.bet[k] = beta[c];
  }

  // ---- phase 1: the held part in flight, the rest folded meanwhile
  const uint64_t keep_l2 = l2_policy_last(), drop_l2 = l2_policy_first();
  const uint32_t sx = (uint32_t)__cvta_generic_to_shared(xs);
  const uint32_t sg = (uint32_t)__cvta_generic_to_shared(gs);
  for (int j = t; j < K; j += T_) {
    cp_async16(sx + j * 16, x + base + j, drop_l2);
    cp_async16(sg + j * 16, g + base + j, drop_l2);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  float a1[E], a2[E];
#pragma unroll
  for (int k = 0; k < E; ++k) a1[k] = a2[k] = 0.f;
  for (long long j0 = K + t; j0 < Q; j0 += 4LL * T_) {
    uint4 xv[4], gv[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const long long j = j0 + (long long)u * T_;
      if (j < Q) {
        xv[u] = ldg_nc(x + base + j, keep_l2);
        gv[u] = ldg_nc(g + base + j, keep_l2);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (j0 + (long long)u * T_ < Q) fold<T, ACT>(xv[u], gv[u], ch, a1, a2);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  for (int j = t; j < K; j += T_) fold<T, ACT>(xs[j], gs[j], ch, a1, a2);
#if defined(IN_ACT_BWD_PROBE) && IN_ACT_BWD_PROBE == 1
  if (a1[0] + a2[E - 1] == -1.2345e30f) part[0] = 0.f;  // keeps the folds
  return;
#endif

  // block reduction in a fixed order: rows of threads sharing channels
  float* bp = part + ((long long)n * bps + r) * C;
  const long long plane = (long long)N * bps * C;  // s1 block, then s2 block
  block_reduce<E>(red, a1, a2, row, cv, rows, C, bp, plane);

#if defined(IN_ACT_BWD_PROBE) && IN_ACT_BWD_PROBE == 2
  return;
#endif
  grid_barrier<SC>(bar, gridDim.x);
#if defined(IN_ACT_BWD_PROBE) && IN_ACT_BWD_PROBE == 3
  return;
#endif

  // ---- phase 2: the (n, column) sums of the partials, spread over every
  // warp of the grid, then a second barrier, then dx
  const int nwarps = T_ / 32, lane = t % 32;  // full warps only
  float* totg = part + 2 * plane;             // (N, 2C): s1 then s2 of each n
  for (long long jj = (long long)blockIdx.x * nwarps + t / 32;
       t / 32 < nwarps && jj < 2LL * N * C; jj += (long long)gridDim.x * nwarps) {
    const int nn = (int)(jj / (2 * C)), j = (int)(jj % (2 * C));
    const float s = merge_column(part, nn, j, C, bps, N, lane);
    if (lane == 0) totg[jj] = s;
  }
  grid_barrier<SC>(bar, gridDim.x);
#if defined(IN_ACT_BWD_PROBE) && IN_ACT_BWD_PROBE == 4
  return;
#endif
  if (blockIdx.x == 0) {
    for (int c = t; c < C; c += T_) {
      float d1 = 0.f, d2 = 0.f;
      for (int nn = 0; nn < N; ++nn) {
        d1 += __ldcg(totg + (long long)nn * 2 * C + c);
        d2 += __ldcg(totg + (long long)nn * 2 * C + C + c);
      }
      dbeta[c] = d1;
      dgamma[c] = d2;
    }
  }
  // the sample's sums, read once per block (every thread reading its 16
  // from L2 piled 67K readers onto a few lines: 16 us at (1,16^3,256))
  float* tot = red;  // 2C floats; the reduction rows are free now
  for (int j = t; j < 2 * C; j += T_) tot[j] = __ldcg(totg + (long long)n * 2 * C + j);
  __syncthreads();
  const float inv_s = 1.f / (float)S;
  float m1[E], m2[E];
#pragma unroll
  for (int k = 0; k < E; ++k) {
    m1[k] = tot[cv * E + k] * inv_s;
    m2[k] = tot[C + cv * E + k] * inv_s;
  }
  auto put = [&](long long j, const uint4& v) { stg(dx + base + j, v, drop_l2); };
  // what was not held first, while it may still sit in L2, and last read
  // first: phase 1 walked it forwards, so its tail is the freshest in L2
  const long long step = 4LL * T_;
  for (long long j0 = Q - K > t ? K + t + (Q - K - 1 - t) / step * step : -1;
       j0 >= K; j0 -= step) {
    uint4 xv[4], gv[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const long long j = j0 + (long long)u * T_;
      if (j < Q) {
        xv[u] = ldg_nc(x + base + j, drop_l2);
        gv[u] = ldg_nc(g + base + j, drop_l2);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const long long j = j0 + (long long)u * T_;
      if (j < Q) put(j, dx_vec<T, ACT>(xv[u], gv[u], ch, m1, m2));
    }
  }
  for (int j = t; j < K; j += T_) put(j, dx_vec<T, ACT>(xs[j], gs[j], ch, m1, m2));
}

// ---- the small-volume form: one block per E-channel column of all N
// samples (N S <= 4096 voxels, held in shared memory), no grid barrier: the
// block's threads fold strided voxels, reduce over the warp by a butterfly
// and over the warps in order, then write dx from what they hold.
template <typename T, int ACT>
__global__ void __launch_bounds__(MAX_THREADS, 1)
    in_act_bwd_column_kernel(const uint4* __restrict__ x,
                             const uint4* __restrict__ g, uint4* __restrict__ dx,
                             const float* __restrict__ mean,
                             const float* __restrict__ rstd,
                             const float* __restrict__ gamma,
                             const float* __restrict__ beta,
                             float* __restrict__ dgamma,
                             float* __restrict__ dbeta, int N, int S, int C) {
  constexpr int E = Vec<T>::E;
  extern __shared__ __align__(16) uint4 smem[];
  const int T_ = blockDim.x, t = threadIdx.x, nwarps = T_ / 32, lane = t % 32;
  const int CV = C / E, cv = blockIdx.x, NS = N * S;
  uint4* xs = smem;
  uint4* gs = smem + NS;
  float* red = reinterpret_cast<float*>(smem + 2 * NS);  // nwarps x 2E
  float* tot = red + nwarps * 2 * E;                     // N x 2E: s1, s2
  const uint64_t drop_l2 = l2_policy_first();
  const uint32_t sx = (uint32_t)__cvta_generic_to_shared(xs);
  const uint32_t sg = (uint32_t)__cvta_generic_to_shared(gs);
  for (int i = t; i < NS; i += T_) {
    cp_async16(sx + i * 16, x + (long long)i * CV + cv, drop_l2);
    cp_async16(sg + i * 16, g + (long long)i * CV + cv, drop_l2);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  auto chan = [&](int n) {
    Chan<E> ch;
#pragma unroll
    for (int k = 0; k < E; ++k) {
      const int c = cv * E + k;
      ch.mean[k] = mean[n * C + c];
      ch.rstd[k] = rstd[n * C + c];
      ch.gam[k] = gamma[c];
      ch.bet[k] = beta[c];
    }
    return ch;
  };
  for (int n = 0; n < N; ++n) {
    const Chan<E> ch = chan(n);
    float a1[E], a2[E];
#pragma unroll
    for (int k = 0; k < E; ++k) a1[k] = a2[k] = 0.f;
    for (int v = t; v < S; v += T_)
      fold<T, ACT>(xs[n * S + v], gs[n * S + v], ch, a1, a2);
#pragma unroll
    for (int k = 0; k < E; ++k)
#pragma unroll
      for (int m = 1; m < 32; m <<= 1) {
        a1[k] += __shfl_xor_sync(0xFFFFFFFFu, a1[k], m);
        a2[k] += __shfl_xor_sync(0xFFFFFFFFu, a2[k], m);
      }
    if (lane == 0)
#pragma unroll
      for (int k = 0; k < E; ++k) {
        red[(t / 32) * 2 * E + k] = a1[k];
        red[(t / 32) * 2 * E + E + k] = a2[k];
      }
    __syncthreads();
    if (t < 2 * E) {
      float s = 0.f;
      for (int w = 0; w < nwarps; ++w) s += red[w * 2 * E + t];
      tot[n * 2 * E + t] = s;
    }
    __syncthreads();
  }
  if (t < E) {
    float d1 = 0.f, d2 = 0.f;
    for (int n = 0; n < N; ++n) {
      d1 += tot[n * 2 * E + t];
      d2 += tot[n * 2 * E + E + t];
    }
    dbeta[cv * E + t] = d1;
    dgamma[cv * E + t] = d2;
  }
  const float inv_s = 1.f / (float)S;
  for (int n = 0; n < N; ++n) {
    const Chan<E> ch = chan(n);
    float m1[E], m2[E];
#pragma unroll
    for (int k = 0; k < E; ++k) {
      m1[k] = tot[n * 2 * E + k] * inv_s;
      m2[k] = tot[n * 2 * E + E + k] * inv_s;
    }
    for (int v = t; v < S; v += T_) {
      const int i = n * S + v;
      stg(dx + (long long)i * CV + cv, dx_vec<T, ACT>(xs[i], gs[i], ch, m1, m2),
          drop_l2);
    }
  }
}

// ---- the cluster form (one sample): blockIdx.x is the block's rank k in a
// cluster of K = gridDim.x blocks over the S voxels, blockIdx.y its group of
// W 16-byte vectors (W E channels); each block holds its range [S k / K,
// S (k + 1) / K) of the group in shared memory, folds it, reduces over the
// block into `mine` (2 W E floats), and after the cluster barrier every
// block merges the K blocks' `mine` through distributed shared memory in
// the grid merge's order, then writes dx from what it holds. A second
// cluster barrier, arrived at after the merge's reads and waited for at the
// end, keeps every block's shared memory alive while the others read it.

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// f32 at shared::cta address `a` of the cluster's block `rank`
__device__ __forceinline__ float ld_rank(const float* a, unsigned rank) {
  uint32_t local = (uint32_t)__cvta_generic_to_shared(a), remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote) : "r"(local), "r"(rank));
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(remote) : "memory");
  return v;
}

template <typename T, int ACT>
__global__ void __launch_bounds__(MAX_THREADS, 1)
    in_act_bwd_cluster_kernel(const uint4* __restrict__ x,
                              const uint4* __restrict__ g, uint4* __restrict__ dx,
                              const float* __restrict__ mean,
                              const float* __restrict__ rstd,
                              const float* __restrict__ gamma,
                              const float* __restrict__ beta,
                              float* __restrict__ dgamma,
                              float* __restrict__ dbeta, int S, int C, int W,
                              int keep) {
  constexpr int E = Vec<T>::E;
  extern __shared__ __align__(16) uint4 smem[];
  const int T_ = blockDim.x, t = threadIdx.x;
  const int K = gridDim.x, k = blockIdx.x, grp = blockIdx.y;
  const int CV = C / E, CB = W * E;   // vectors a voxel; channels of the block
  const int w = t % W, row = t / W, rows = T_ / W;
  const int v0 = (int)((long long)S * k / K), v1 = (int)((long long)S * (k + 1) / K);
  const int Q = (v1 - v0) * W;        // vectors held
  uint4* xs = smem;
  uint4* gs = smem + keep;
  float* red = reinterpret_cast<float*>(smem + 2 * keep);  // rows x CB
  float* mine = red + T_ * E;                             // 2 CB: s1, s2
#if defined(IN_ACT_BWD_PROBE) && IN_ACT_BWD_PROBE == 0
  cluster_arrive();
  cluster_wait();
  return;
#endif
  // the 16-byte vector j of the block: voxel v0 + j / W, vector grp W + j % W
  auto at = [&](int j) { return (long long)(v0 + j / W) * CV + grp * W + j % W; };
  const uint64_t drop_l2 = l2_policy_first();
  const uint32_t sx = (uint32_t)__cvta_generic_to_shared(xs);
  const uint32_t sg = (uint32_t)__cvta_generic_to_shared(gs);
  for (int j = t; j < Q; j += T_) {
    cp_async16(sx + j * 16, x + at(j), drop_l2);
    cp_async16(sg + j * 16, g + at(j), drop_l2);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  Chan<E> ch;
#pragma unroll
  for (int kk = 0; kk < E; ++kk) {
    const int c = (grp * W + w) * E + kk;
    ch.mean[kk] = mean[c];
    ch.rstd[kk] = rstd[c];
    ch.gam[kk] = gamma[c];
    ch.bet[kk] = beta[c];
  }
  float a1[E], a2[E];
#pragma unroll
  for (int kk = 0; kk < E; ++kk) a1[kk] = a2[kk] = 0.f;
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  for (int j = t; j < Q; j += T_) fold<T, ACT>(xs[j], gs[j], ch, a1, a2);
#if defined(IN_ACT_BWD_PROBE) && IN_ACT_BWD_PROBE == 1
  if (a1[0] + a2[E - 1] == -1.2345e30f) dbeta[0] = 0.f;  // keeps the folds
  return;
#endif
  block_reduce<E>(red, a1, a2, row, w, rows, CB, mine, CB);
#if defined(IN_ACT_BWD_PROBE) && IN_ACT_BWD_PROBE == 2
  return;
#endif
  cluster_arrive();  // mine is written (release), then every block's (acquire)
  cluster_wait();
#if defined(IN_ACT_BWD_PROBE) && IN_ACT_BWD_PROBE == 3
  return;
#endif
  // the merge: a warp a column of 2 CB, lane q takes block q (q < K <= 16),
  // then the butterfly: the grid merge's order at bps = K
  const int nwarps = T_ / 32, lane = t % 32;  // full warps only
  float* tot = red;                           // 2 CB floats; the rows are free
  for (int j = t / 32; t / 32 < nwarps && j < 2 * CB; j += nwarps) {
    float v = lane < K ? ld_rank(mine + j, (unsigned)lane) : 0.f;
#pragma unroll
    for (int m = 1; m < 32; m <<= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, m);
    if (lane == 0) tot[j] = v;
  }
  __syncthreads();
  cluster_arrive();  // this block's reads of the others' mine are done
#if defined(IN_ACT_BWD_PROBE) && IN_ACT_BWD_PROBE == 4
  cluster_wait();
  return;
#endif
  if (k == 0)
    for (int c = t; c < CB; c += T_) {
      dbeta[grp * CB + c] = 0.f + tot[c];
      dgamma[grp * CB + c] = 0.f + tot[CB + c];
    }
  const float inv_s = 1.f / (float)S;
  float m1[E], m2[E];
#pragma unroll
  for (int kk = 0; kk < E; ++kk) {
    m1[kk] = tot[w * E + kk] * inv_s;
    m2[kk] = tot[CB + w * E + kk] * inv_s;
  }
  for (int j = t; j < Q; j += T_)
    stg(dx + at(j), dx_vec<T, ACT>(xs[j], gs[j], ch, m1, m2), drop_l2);
  cluster_wait();    // no block leaves while another may read its mine
}

constexpr int MAX_DEVICES = 64;
constexpr int SMEM_MAX = 232448;  // the opt-in limit of one block on an H100

// Blocks of up to MAX_THREADS threads and SMEM_MAX bytes that fit on the
// device at once (the occupancy API times the SMs), per device and
// instance; the instance's shared-memory limit is raised on first use.
template <typename T, int ACT>
int resident_blocks() {
  static int cap[MAX_DEVICES] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= MAX_DEVICES) return -1;
  if (cap[dev] == 0) {
    auto kernel = in_act_bwd_kernel<T, ACT>;
    int sms = 0, per_sm = 0;
    if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_MAX) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      MAX_THREADS, SMEM_MAX) !=
            cudaSuccess)
      return -1;
    cap[dev] = per_sm * sms;
  }
  return cap[dev];
}

template <typename T, int ACT>
int launch(const void* x, const void* g, void* dx, const float* mean,
           const float* rstd, const float* gamma, const float* beta,
           float* part, float* dgamma, float* dbeta, unsigned int* bar, int N,
           long long S, int C, int bps, int threads, int keep, int smem,
           cudaStream_t stream) {
  const int cap = resident_blocks<T, ACT>();
  if (cap < 0) return (int)cudaGetLastError();
  // the grid barrier needs every block resident at once
  if ((long long)N * bps > cap || smem > SMEM_MAX)
    return (int)cudaErrorCooperativeLaunchTooLarge;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(N * bps));
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, in_act_bwd_kernel<T, ACT>, static_cast<const uint4*>(x),
      static_cast<const uint4*>(g), static_cast<uint4*>(dx), mean, rstd, gamma,
      beta, part, dgamma, dbeta, bar, N, S, C, bps, keep);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T, int ACT>
int launch_column(const void* x, const void* g, void* dx, const float* mean,
                  const float* rstd, const float* gamma, const float* beta,
                  float* dgamma, float* dbeta, int N, int S, int C, int threads,
                  int smem, cudaStream_t stream) {
  static bool raised[MAX_DEVICES] = {false};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= MAX_DEVICES)
    return (int)cudaErrorInvalidDevice;
  if (!raised[dev]) {
    cudaError_t err = cudaFuncSetAttribute(
        in_act_bwd_column_kernel<T, ACT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (err != cudaSuccess) return (int)err;
    raised[dev] = true;
  }
  in_act_bwd_column_kernel<T, ACT><<<C / Vec<T>::E, threads, smem, stream>>>(
      static_cast<const uint4*>(x), static_cast<const uint4*>(g),
      static_cast<uint4*>(dx), mean, rstd, gamma, beta, dgamma, dbeta, N, S, C);
  return (int)cudaGetLastError();
}

template <typename T, int ACT>
int launch_cluster(const void* x, const void* g, void* dx, const float* mean,
                   const float* rstd, const float* gamma, const float* beta,
                   float* dgamma, float* dbeta, int S, int C, int K, int W,
                   int threads, int keep, int smem, cudaStream_t stream) {
  static bool raised[MAX_DEVICES] = {false};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= MAX_DEVICES)
    return (int)cudaErrorInvalidDevice;
  auto kernel = in_act_bwd_cluster_kernel<T, ACT>;
  if (!raised[dev]) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
    raised[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)K, (unsigned)(C / Vec<T>::E / W));
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)K;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const uint4*>(x), static_cast<const uint4*>(g),
      static_cast<uint4*>(dx), mean, rstd, gamma, beta, dgamma, dbeta, S, C, W,
      keep);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int grid_entry(const void* x, const void* g, void* dx, const void* mean,
               const void* rstd, const void* gamma, const void* beta, void* part,
               void* dgamma, void* dbeta, void* bar, int N, long long S, int C,
               int act, int bps, int threads, int keep, int smem,
               void* stream) {
  constexpr int E = Vec<T>::E;
  if (N < 1 || S < 1 || C < E || C % E || bps < 1 || threads < 1 ||
      threads > MAX_THREADS || threads % (C / E) || 2 * C > E * threads ||
      keep < 0 || keep % (C / E) || act < 0 || act > 2 ||
      (long long)N * bps > 0x7FFFFFFFLL ||
      smem != 32 * keep + 4 * E * threads ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(g) |
       reinterpret_cast<uintptr_t>(dx)) % 16)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto m = [](void* p) { return static_cast<float*>(p); };
  auto b = static_cast<unsigned int*>(bar);
  switch (act) {
    case 1:
      return launch<T, 1>(x, g, dx, f(mean), f(rstd), f(gamma), f(beta),
                          m(part), m(dgamma), m(dbeta), b, N, S, C, bps, threads,
                          keep, smem, s);
    case 2:
      return launch<T, 2>(x, g, dx, f(mean), f(rstd), f(gamma), f(beta),
                          m(part), m(dgamma), m(dbeta), b, N, S, C, bps, threads,
                          keep, smem, s);
    default:
      return launch<T, 0>(x, g, dx, f(mean), f(rstd), f(gamma), f(beta),
                          m(part), m(dgamma), m(dbeta), b, N, S, C, bps, threads,
                          keep, smem, s);
  }
}

template <typename T>
int column_entry(const void* x, const void* g, void* dx, const void* mean,
                 const void* rstd, const void* gamma, const void* beta,
                 void* dgamma, void* dbeta, int N, int S, int C, int act,
                 int threads, int smem, void* stream) {
  constexpr int E = Vec<T>::E;
  if (N < 1 || S < 1 || C < E || C % E || C / E > 65535 || threads < 32 ||
      threads > MAX_THREADS || threads % 32 || act < 0 || act > 2 ||
      (long long)N * S > 4096 ||
      smem != 32 * N * S + 8 * E * (threads / 32) + 8 * E * N ||
      smem > SMEM_MAX ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(g) |
       reinterpret_cast<uintptr_t>(dx)) % 16)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto m = [](void* p) { return static_cast<float*>(p); };
  switch (act) {
    case 1:
      return launch_column<T, 1>(x, g, dx, f(mean), f(rstd), f(gamma), f(beta),
                                 m(dgamma), m(dbeta), N, S, C, threads, smem, s);
    case 2:
      return launch_column<T, 2>(x, g, dx, f(mean), f(rstd), f(gamma), f(beta),
                                 m(dgamma), m(dbeta), N, S, C, threads, smem, s);
    default:
      return launch_column<T, 0>(x, g, dx, f(mean), f(rstd), f(gamma), f(beta),
                                 m(dgamma), m(dbeta), N, S, C, threads, smem, s);
  }
}

template <typename T>
int cluster_entry(const void* x, const void* g, void* dx, const void* mean,
                  const void* rstd, const void* gamma, const void* beta,
                  void* dgamma, void* dbeta, int S, int C, int act, int K, int W,
                  int threads, int keep, int smem, void* stream) {
  constexpr int E = Vec<T>::E;
  if (S < 1 || C < E || C % E || K < 1 || K > MAX_CLUSTER || K > S || W < 1 ||
      (C / E) % W || C / E / W > 65535 || threads < 32 || threads > MAX_THREADS ||
      threads % 32 || threads % W || 2 * W > threads || act < 0 || act > 2 ||
      keep != (S + K - 1) / K * W || smem != 32 * keep + 4 * E * threads + 8 * W * E ||
      smem > SMEM_MAX ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(g) |
       reinterpret_cast<uintptr_t>(dx)) % 16)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto m = [](void* p) { return static_cast<float*>(p); };
  switch (act) {
    case 1:
      return launch_cluster<T, 1>(x, g, dx, f(mean), f(rstd), f(gamma), f(beta),
                                  m(dgamma), m(dbeta), S, C, K, W, threads, keep,
                                  smem, s);
    case 2:
      return launch_cluster<T, 2>(x, g, dx, f(mean), f(rstd), f(gamma), f(beta),
                                  m(dgamma), m(dbeta), S, C, K, W, threads, keep,
                                  smem, s);
    default:
      return launch_cluster<T, 0>(x, g, dx, f(mean), f(rstd), f(gamma), f(beta),
                                  m(dgamma), m(dbeta), S, C, K, W, threads, keep,
                                  smem, s);
  }
}

}  // namespace

// x, g, dx: (N, S, C) contiguous bf16, 16-byte aligned, C % 8 == 0; mean,
// rstd (N, C), gamma, beta (C) f32; part: f32 scratch of 2 * N * (bps + 1)
// * C (the blocks' partials, then the per-sample sums);
// dgamma, dbeta (C) f32 out; bar: two unsigned ints zeroed on `stream`
// before the launch and used by no other launch (the grid barrier's state;
// the caller makes them anew each call, so launches on other streams or
// from a CUDA graph never share them). act: 0 none, 1 relu, 2 leaky relu
// (0.01). The launch plan (bps blocks per sample, threads a multiple of C/8
// up to 512, keep vectors of x and g held per block, a multiple of C/8,
// smem bytes = 32 keep + 32 threads) comes from ops/norm.py
// plan_in_bwd. Launches cooperatively on `stream`; returns the CUDA error
// code (0 when the launch went out).
extern "C" int in_act_bwd_ndhwc_bf16(const void* x, const void* g, void* dx,
                                     const void* mean, const void* rstd,
                                     const void* gamma, const void* beta,
                                     void* part, void* dgamma, void* dbeta,
                                     void* bar, int N, long long S, int C,
                                     int act, int bps, int threads, int keep,
                                     int smem, void* stream) {
  return grid_entry<__nv_bfloat16>(x, g, dx, mean, rstd, gamma, beta, part,
                                   dgamma, dbeta, bar, N, S, C, act, bps,
                                   threads, keep, smem, stream);
}

// The same in f32: x, g, dx f32, C % 4 == 0, threads a multiple of C/4,
// keep a multiple of C/4, smem = 32 keep + 16 threads.
extern "C" int in_act_bwd_ndhwc_f32(const void* x, const void* g, void* dx,
                                    const void* mean, const void* rstd,
                                    const void* gamma, const void* beta,
                                    void* part, void* dgamma, void* dbeta,
                                    void* bar, int N, long long S, int C,
                                    int act, int bps, int threads, int keep,
                                    int smem, void* stream) {
  return grid_entry<float>(x, g, dx, mean, rstd, gamma, beta, part, dgamma,
                           dbeta, bar, N, S, C, act, bps, threads, keep, smem,
                           stream);
}

// The small-volume form (ops/norm.py plan_in_bwd's `column` plans): the same
// arguments less the scratch, the barrier and the grid plan; N S <= 4096,
// threads a multiple of 32 up to 512, smem = 32 N S + 64 threads / 32 + 64 N.
extern "C" int in_act_bwd_column_ndhwc_bf16(const void* x, const void* g,
                                            void* dx, const void* mean,
                                            const void* rstd, const void* gamma,
                                            const void* beta, void* dgamma,
                                            void* dbeta, int N, int S, int C,
                                            int act, int threads, int smem,
                                            void* stream) {
  return column_entry<__nv_bfloat16>(x, g, dx, mean, rstd, gamma, beta, dgamma,
                                     dbeta, N, S, C, act, threads, smem, stream);
}

// The same in f32 (one block per 4-channel column): smem = 32 N S + 32
// threads / 32 + 32 N.
extern "C" int in_act_bwd_column_ndhwc_f32(const void* x, const void* g,
                                           void* dx, const void* mean,
                                           const void* rstd, const void* gamma,
                                           const void* beta, void* dgamma,
                                           void* dbeta, int N, int S, int C,
                                           int act, int threads, int smem,
                                           void* stream) {
  return column_entry<float>(x, g, dx, mean, rstd, gamma, beta, dgamma, dbeta,
                             N, S, C, act, threads, smem, stream);
}

// The cluster form in f32, for one sample (ops/norm.py plan_in_bwd's
// `cluster` plans): x, g, dx (1, S, C) f32; a cluster of K <= 16 blocks
// (grid K x C / (4 W)) over S per group of W 16-byte vectors (W divides
// C / 4), each holding keep = ceil(S / K) W vectors of x and g; threads a
// multiple of 32 and of W up to 512, at least 2 W; smem = 32 keep + 16
// threads + 32 W. No scratch, no barrier counters, no cooperative launch.
extern "C" int in_act_bwd_cluster_ndhwc_f32(const void* x, const void* g,
                                            void* dx, const void* mean,
                                            const void* rstd, const void* gamma,
                                            const void* beta, void* dgamma,
                                            void* dbeta, int S, int C, int act,
                                            int K, int W, int threads, int keep,
                                            int smem, void* stream) {
  return cluster_entry<float>(x, g, dx, mean, rstd, gamma, beta, dgamma, dbeta,
                              S, C, act, K, W, threads, keep, smem, stream);
}
