// SAME stride-1 3x3x3 conv3d for NDHWC volumes on Hopper tensor cores:
// bf16 in, f32 accumulation, bf16 out (round to nearest even), no bias. The
// same function as conv3d.cu, for Ci % 16 == 0 and Co % 8 == 0 (conv3d.cu
// stays the general instance). Built by brats2019_tpu_torch/ops/_build.py with
// nvcc -gencode arch=compute_90a,code=sm_90a; called through ctypes from
// brats2019_tpu_torch/ops/conv.py (conv3d_kernel), which picks the instance
// (box depth, Co tile) from the shape alone (plan_conv).
//
// Replaces: brats2019_tpu/ops/pallas_conv.py conv3d_pallas (:79, kernel
// _kernel :41):  y[n,d,h,w,co] = sum_{kd,kh,kw,ci} x[n,d+kd-1,h+kh-1,w+kw-1,ci]
// * w[kd,kh,kw,ci,co], zeros outside the volume.
//
// What bounds it on the card: tensor-core operations (K = 27*Ci >= 864, hundreds
// of flops per byte of input). What held the mma.sync form (conv3d.cu) at 14%
// of the bf16 peak was not only the instruction: every tap refetched the whole
// 128-row A tile and every block the whole weight, 42.7 flop per byte filled
// into shared memory, so the fills from L2 were the limit. The design cuts the
// bytes filled per flop and takes the fills off the multiplying threads:
//
//   * GEMM view: M = output voxels, N = Co, K = (channel chunk, tap, ci). The
//     DHWIO weight flattened is the (27*Ci, Co) B operand, Co contiguous.
//   * M tile = a BD x 8 x 8 box of voxels of one sample (BD = 4: 256 rows, or
//     2: 128 rows). Per 64-channel chunk the box is loaded ONCE with its halo,
//     a (BD+2) x 10 x 10 patch (2.3x the tile instead of 27x); all 27 taps
//     read shifted views of it.
//   * A goes to the tensor cores straight from that patch (wgmma, A from
//     shared memory, no-swizzle K-major descriptor). The patch is stored
//     channel-piece-major, [ci/8][voxel][8 ci]: 8 consecutive w-voxels x 16
//     bytes are one 8x8 core matrix, the 10-voxel pitch between h-rows is the
//     descriptor's stride between 8-row groups, the piece pitch its leading
//     offset, and a tap shift (kd, kh, kw) is a 16-byte-granular change of the
//     start address. One m64 product covers one d-plane (8 h x 8 w) of the
//     box. This costs the multiplying threads no A work at all (the
//     alternative, ldmatrix into registers at tap-shifted addresses, spends
//     instruction slots and registers of the consumers); its price is that the box's
//     w extent is fixed at 8. The piece pitch is (voxels + 1) x 16 bytes so the
//     loader's 8 pieces of one voxel fall into 8 different bank groups.
//   * The patch is filled by 3 loader warps with zero-filling cp.async (halo
//     outside the volume and ragged boxes read nothing and write zeros: SAME
//     padding without a padded copy, any D, H, W). Each loader keeps one
//     channel piece and walks the voxels, so its address arithmetic is a few
//     instructions a copy (with a runtime division per copy the loaders, not
//     the tensor cores, set the pace). It waits for its copies, fences them
//     towards the async proxy (wgmma reads shared memory through it) and
//     arrives on the patch's full mbarrier; two patch buffers, so chunk c+1
//     loads while chunk c multiplies.
//   * B by TMA: a 2-D tensor map (Co, 27*Ci) with 128-byte swizzle, one slab
//     of 64 K rows x 64 channels per box (NB boxes for a 64*NB-wide tile): one
//     tap of a chunk, or 64/Ci whole taps where Ci is 16 or 32. A ring of 4
//     slabs on full/empty mbarrier pairs, started by one thread of a fourth
//     producer warp. wgmma reads it MN-major (transposed-B flag) through a
//     128B-swizzle descriptor.
//   * Two consumer warpgroups, each BD/2 d-planes of the box, accumulate in
//     registers (32*NB f32 per plane and thread); one wgmma group per slab
//     stays in flight while the previous slab (and at a chunk's end its patch)
//     is released, so the tensor cores drain only at a tile's end.
//   * Persistent blocks, one per SM (the shared memory admits no second):
//     every role walks the same tiles and the rings run on across tiles, so
//     the next tile's patch and slabs load during this tile's products and
//     stores.
//   * Epilogue: accumulators -> bf16, a 4x4 transpose inside each lane quad
//     (two shuffle rounds), then 16-byte stores that cover 64 contiguous bytes
//     of each row; ragged rows and the Co tail masked.
//   * One fixed K order (chunk, tap, ci), no atomics, no split-K: repeat runs
//     are bitwise equal.
//   * A barrier wait that has not completed after 20 s of the card's clock
//     traps instead of hanging the card.
//
// The STATS instance (conv3d_wgmma_stats_ndhwc_bf16) also writes, for every
// (box, output channel), the InstanceNorm statistics of the values it stores,
// so that the norm after the conv need not read y a first time (replaces the
// statistics pass of brats2019_tpu/ops/pallas_norm.py _fwd_pallas, :176; the
// merge and the apply pass are ops/triton_norm.py). Its epilogue:
//   * takes each value after its rounding to bf16 (the norm normalises the
//     bf16 output) and only the box's rows inside the volume; the count of a
//     box is known from its extent and is not reduced;
//   * two passes over the registers, the box's sum then its centred sum of
//     squares around the box's mean (never E[x^2] - mean^2): each thread sums
//     its PPW planes x 2 rows per column, the 8 lanes that share a column are
//     folded by a reduce-scatter, 16 columns at a time (shuffles xor 16, 8,
//     4: 14 for 16 columns, not 3 per column), and the 8 consumer warps
//     through shared memory of
//     its own (the rings run on into the next tile, so no slab is free), in
//     one fixed order;
//   * writes (count, mean, M2) in f32 to partials[3][n][box][co], the box's
//     own slot, so repeat runs are bitwise equal whatever order the
//     persistent blocks walk. y is bitwise the plain instance's.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BH = 8, BW = 8;            // box extent along h and w (fixed)
constexpr int PH = BH + 2, PW = BW + 2;  // patch extent with the halo
constexpr int CK = 64;                   // input channels per chunk
constexpr int NPIECE = CK / 8;           // 16-byte channel pieces per chunk
constexpr int BSTAGES = 4;               // weight slabs in the ring
constexpr int PSTAGES = 2;               // patch buffers
constexpr int CONSUMER_WARPS = 8;        // two warpgroups
constexpr int THREADS = 384;             // + one producer warpgroup
constexpr int A_LOADERS = 96;            // producer warps 1..3 fill the patch
static_assert(A_LOADERS % 2 == 0 && A_LOADERS % 4 == 0 && A_LOADERS % 6 == 0 &&
                  A_LOADERS % 8 == 0,
              "a loader keeps one of 2, 4, 6 or 8 channel pieces");
constexpr int SLAB_BOX_BYTES = CK * 128; // one TMA box: 64 k-rows x 64 co
// A wait that has not completed after this long on the card's clock traps (a
// wrong barrier phase would otherwise hang the card). The clock is read once
// in SPIN_CHECK polls, so a healthy wait pays nothing for it.
constexpr unsigned long long WAIT_LIMIT_NS = 20ull * 1000 * 1000 * 1000;
constexpr int SPIN_CHECK = 1 << 16;

template <int BD>
struct Geo {
  static constexpr int PD = BD + 2;
  static constexpr int NVOX = PD * PH * PW;
  static constexpr int PIECE_BYTES = (NVOX + 1) * 16;
  static constexpr int PATCH_BYTES = NPIECE * PIECE_BYTES;
};

// the STATS epilogue's scratch: a row of column sums per consumer warp and
// the box means, 64 * NB columns each
template <int NB>
constexpr int stats_bytes() {
  return (CONSUMER_WARPS + 1) * NB * 64 * 4;
}

template <int BD, int NB, bool STATS = false>
constexpr int smem_bytes() {
  return 1024 + BSTAGES * NB * SLAB_BOX_BYTES + PSTAGES * Geo<BD>::PATCH_BYTES +
         8 * (2 * BSTAGES + 2 * PSTAGES) + (STATS ? stats_bytes<NB>() : 0);
}

// ---------------------------------------------------------------- PTX --

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}
// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  int spins = 0;
  unsigned long long t0 = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && ++spins == SPIN_CHECK) {
      spins = 0;
      unsigned long long now;
      asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(now));
      if (!t0) t0 = now;
      if (now - t0 > WAIT_LIMIT_NS) __trap();
    }
  } while (!done);
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  int n = valid ? 16 : 0;  // src-size 0: write 16 zero bytes, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// D(64 x 64, f32) += A(64 x 16, K-major, no swizzle) * B(16 x 64, MN-major,
// 128B swizzle), both from shared memory
__device__ __forceinline__ void wgmma_tile(float (&d)[32], uint64_t a,
                                           uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}
// the same with a 128-wide B (two 64-channel boxes, the second at the
// descriptor's leading offset)
__device__ __forceinline__ void wgmma_tile(float (&d)[64], uint64_t a,
                                           uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

// the 256 consumer threads (warps 0..7) only
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Sums v[c] over the 8 lanes that share lane & 3, as a reduce-scatter:
// rounds xor 16, 8, 4 each keep half of the values and add the partner's
// copy of that half. Lane l ends with r[k] = the sum of v[k + NV/8 * (l >> 2)],
// k < NV/8. One fixed order: repeat runs are bitwise equal.
template <int SPAN, int NV>
__device__ __forceinline__ void scatter_round(float (&v)[NV], int lane,
                                              int bit) {
  const bool up = lane & bit;
#pragma unroll
  for (int k = 0; k < SPAN; ++k) {
    const float send = up ? v[k] : v[k + SPAN];
    const float keep = up ? v[k + SPAN] : v[k];
    v[k] = keep + __shfl_xor_sync(0xffffffffu, send, bit);
  }
}
template <int NV>
__device__ __forceinline__ void lane_reduce_scatter(float (&v)[NV], int lane) {
  scatter_round<NV / 2>(v, lane, 16);
  scatter_round<NV / 4>(v, lane, 8);
  scatter_round<NV / 8>(v, lane, 4);
}

// keeps the compiler from moving reads of the accumulators across the wait
// that completes the asynchronous products
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// shared-memory matrix descriptor: start address, leading and stride byte
// offsets in 16-byte units, layout (0 none, 1 128-byte swizzle)
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo_bytes,
                                              uint32_t sbo_bytes,
                                              uint32_t layout) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(lbo_bytes >> 4) << 16) |
         ((uint64_t)(sbo_bytes >> 4) << 32) | ((uint64_t)layout << 62);
}

// ------------------------------------------------------------- kernel --

// one output tile: a box of one sample and a Co tile
struct Tile {
  int n, d0, h0, w0, n0;
};
template <int BD, int NB>
__device__ __forceinline__ Tile decode_tile(int t, int nbd, int nbh, int nbw,
                                            int ntiles) {
  Tile r;
  r.n0 = (t % ntiles) * (NB * 64);  // Co tiles of one box run side by side
  t /= ntiles;
  r.w0 = (t % nbw) * BW;
  t /= nbw;
  r.h0 = (t % nbh) * BH;
  t /= nbh;
  r.d0 = (t % nbd) * BD;
  r.n = t / nbd;
  return r;
}

// The STATS epilogue of one tile (see the head of the file): (count, mean, M2)
// of each of the tile's output channels over the box's rows inside the volume,
// from the accumulators already rounded to bf16 with the outside rows zeroed.
// Column c of this thread's values is 8 * (c / 2) + 2 * (lane & 3) + c % 2.
template <int BD, int NB>
__device__ __forceinline__ void box_stats(
    float (&acc)[BD / 2][NB * 32], float* red, float* box_mean,
    float* __restrict__ part, const Tile& tl, int N, int D, int H, int W,
    int Co, int nbh, int nbw, int nboxes, int tid, int warp, int lane) {
  constexpr int PPW = BD / 2;
  constexpr int NV = NB * 16;       // this thread's columns
  constexpr int NCOL = NB * 64;     // the tile's
  const int wg = warp >> 2, q = warp & 3;
  const int ww = tl.w0 + (lane >> 2);
  const int vd = min(BD, D - tl.d0), vh = min(BH, H - tl.h0),
            vw = min(BW, W - tl.w0);
  const float cnt = (float)(vd * vh * vw);
  const bool full = vd == BD && vh == BH && vw == BW;
  auto col_of = [&](int c) { return 8 * (c >> 1) + 2 * (lane & 3) + (c & 1); };

  // the columns go in groups of 16 (NB groups), which keeps the 128
  // accumulators of the 128-wide tile and the reduction within 168 registers
  consumer_sync();  // the previous tile's readers of the scratch are done
  // pass 1: the box's sum of each column
#pragma unroll
  for (int g = 0; g < NV; g += 16) {
    float v[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int c = g + k;
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < PPW; ++i)
#pragma unroll
        for (int half = 0; half < 2; ++half)
          s += acc[i][4 * (c >> 1) + 2 * half + (c & 1)];
      v[k] = s;
    }
    lane_reduce_scatter<16>(v, lane);
#pragma unroll
    for (int k = 0; k < 2; ++k)
      red[warp * NCOL + col_of(g + k + 2 * (lane >> 2))] = v[k];
  }
  consumer_sync();
  if (tid < NCOL) {
    float s = 0.f;
#pragma unroll
    for (int w8 = 0; w8 < CONSUMER_WARPS; ++w8) s += red[w8 * NCOL + tid];
    box_mean[tid] = s / cnt;
  }
  consumer_sync();
  // pass 2: the centred sum of squares around the box's mean
#pragma unroll
  for (int g = 0; g < NV; g += 16) {
    float v[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int c = g + k;
      const float mu = box_mean[col_of(c)];
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < PPW; ++i)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float d = acc[i][4 * (c >> 1) + 2 * half + (c & 1)] - mu;
          const bool ok = full || (tl.d0 + wg * PPW + i < D &&
                                   tl.h0 + 2 * q + half < H && ww < W);
          s += ok ? d * d : 0.f;
        }
      v[k] = s;
    }
    lane_reduce_scatter<16>(v, lane);
#pragma unroll
    for (int k = 0; k < 2; ++k)
      red[warp * NCOL + col_of(g + k + 2 * (lane >> 2))] = v[k];
  }
  consumer_sync();
  if (tid < NCOL && tl.n0 + tid < Co) {
    float m2 = 0.f;
#pragma unroll
    for (int w8 = 0; w8 < CONSUMER_WARPS; ++w8) m2 += red[w8 * NCOL + tid];
    const int box = ((tl.d0 / BD) * nbh + tl.h0 / BH) * nbw + tl.w0 / BW;
    const long long stride = (long long)N * nboxes * Co;
    const long long slot = ((long long)tl.n * nboxes + box) * Co + tl.n0 + tid;
    part[slot] = cnt;
    part[stride + slot] = box_mean[tid];
    part[2 * stride + slot] = m2;
  }
}

template <int BD, int NB, bool STATS>
__global__ void __launch_bounds__(THREADS, 1)
    conv3d_wgmma_kernel(const __grid_constant__ CUtensorMap wmap,
                        const __nv_bfloat16* __restrict__ x,
                        __nv_bfloat16* __restrict__ y,
                        float* __restrict__ part, int N, int D, int H, int W,
                        int Ci, int Co, int nbd, int nbh, int nbw, int ntiles,
                        int total) {
  using G = Geo<BD>;
  constexpr int PPW = BD / 2;  // d-planes per consumer warpgroup
  constexpr int B_STAGE = NB * SLAB_BOX_BYTES;

  extern __shared__ unsigned char smem_raw[];
  // the swizzled slabs want 1024-byte alignment
  const uint32_t ring =
      ((uint32_t)__cvta_generic_to_shared(smem_raw) + 1023u) & ~1023u;
  const uint32_t patch = ring + BSTAGES * B_STAGE;
  const uint32_t full_b = patch + PSTAGES * G::PATCH_BYTES;
  const uint32_t empty_b = full_b + 8 * BSTAGES;
  const uint32_t full_p = empty_b + 8 * BSTAGES;
  const uint32_t empty_p = full_p + 8 * PSTAGES;
  // the STATS scratch: [CONSUMER_WARPS][NB * 64] column sums, [NB * 64] means
  float* const red = reinterpret_cast<float*>(
      smem_raw + (empty_p + 8 * PSTAGES -
                  (uint32_t)__cvta_generic_to_shared(smem_raw)));
  float* const box_mean = red + CONSUMER_WARPS * NB * 64;

  const int tid = threadIdx.x;
  // through a shuffle, so the compiler knows the role branches below are
  // warp-uniform (else it serialises the wgmmas as if in a divergent path)
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int lane = tid & 31;
  const int nchunks = (Ci + CK - 1) / CK;
  // Taps per weight slab. A slab is 64 consecutive K rows, and K runs (tap,
  // ci): where Ci divides 64 (one chunk of 16 or 32 channels) a slab holds 4
  // or 2 whole taps, and the products of all of them go out behind one
  // barrier; rows past the 27th tap are out of bounds and arrive as zeros.
  const int tps = (CK % Ci == 0) ? CK / Ci : 1;

  if (tid == 0) {
    for (int i = 0; i < BSTAGES; ++i) {
      mbar_init(full_b + 8 * i, 1);
      mbar_init(empty_b + 8 * i, CONSUMER_WARPS);
    }
    for (int i = 0; i < PSTAGES; ++i) {
      mbar_init(full_p + 8 * i, A_LOADERS);
      mbar_init(empty_p + 8 * i, CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Every role walks the same tiles (blockIdx.x, + gridDim.x, ...) and the
  // rings run on across tiles: the producers fill the next tile's first patch
  // and slabs while the consumers finish and store this one.
  if (warp == CONSUMER_WARPS) {
    // ---- weight slabs by TMA, one thread
    if (lane == 0) {
      int s = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < total; t += gridDim.x) {
        const int n0 = (t % ntiles) * (NB * 64);
        // Boxes of this tile that start inside Co. Where the second box of a
        // 128-wide tile starts past Co it is not loaded: the n128 products
        // then read whatever an earlier slab left in that half of the stage.
        // Those sums land only in columns >= Co, which the store masks.
        int nbox = NB;
        if (n0 + (NB - 1) * 64 >= Co) nbox = NB - 1;
        for (int c = 0; c < nchunks; ++c) {
          for (int tap = 0; tap < 27; tap += tps) {
            mbar_wait(empty_b + 8 * s, phase ^ 1);
            mbar_arrive_expect_tx(full_b + 8 * s, nbox * SLAB_BOX_BYTES);
            for (int g = 0; g < nbox; ++g)
              tma_load_2d(ring + s * B_STAGE + g * SLAB_BOX_BYTES, &wmap,
                          full_b + 8 * s, n0 + g * 64, tap * Ci + c * CK);
            if (++s == BSTAGES) {
              s = 0;
              phase ^= 1;
            }
          }
        }
      }
    }
  } else if (warp > CONSUMER_WARPS) {
    // ---- the halo patch by zero-filling cp.async, 96 threads
    const int lt = tid - (CONSUMER_WARPS + 1) * 32;
    int cc = 0;  // chunks so far: buffer cc & 1, its use number cc >> 1
    for (int t = blockIdx.x; t < total; t += gridDim.x) {
      const Tile tl = decode_tile<BD, NB>(t, nbd, nbh, nbw, ntiles);
      const __nv_bfloat16* xn = x + (long long)tl.n * D * H * W * Ci;
      for (int c = 0; c < nchunks; ++c, ++cc) {
        const int pb = cc & 1;
        mbar_wait(empty_p + 8 * pb, ((cc >> 1) & 1) ^ 1);
        const int ci0 = c * CK;
        const int np = (min(CK, Ci - ci0)) >> 3;  // pieces of this chunk
        // A thread keeps one piece j and walks the voxels in steps of
        // 96 / np (np is 2, 4, 6 or 8), so the only runtime division is here;
        // 8 threads of a voxel read 128 contiguous bytes.
        const int j = lt % np, vstep = A_LOADERS / np;
        const uint32_t dst0 = patch + pb * G::PATCH_BYTES + j * G::PIECE_BYTES;
        const __nv_bfloat16* xc = xn + ci0 + j * 8;
#pragma unroll 4
        for (int v = lt / np; v < G::NVOX; v += vstep) {
          const int a = v / (PH * PW);
          const int rem = v - a * (PH * PW);
          const int bb = rem / PW;
          const int cw = rem - bb * PW;
          const int dd = tl.d0 - 1 + a, hh = tl.h0 - 1 + bb,
                    ww = tl.w0 - 1 + cw;
          const bool ok =
              dd >= 0 && dd < D && hh >= 0 && hh < H && ww >= 0 && ww < W;
          const long long src = (long long)((dd * H + hh) * W + ww) * Ci;
          cp_async16(dst0 + v * 16, ok ? (const void*)(xc + src) : (const void*)x,
                     ok);
        }
        // the loaders have a whole chunk's products of slack: each waits for
        // its own copies, makes them visible to the async proxy (wgmma reads
        // shared memory through it) and arrives
        asm volatile("cp.async.wait_all;\n" ::: "memory");
        fence_proxy_async();
        mbar_arrive(full_p + 8 * pb);
      }
    }
  } else {
    // ---- products: two warpgroups, PPW d-planes of the box each
    const int wg = warp >> 2;
    const int q = warp & 3;
    const uint64_t a_hi = make_desc(0, G::PIECE_BYTES, PW * 16, 0);
    const uint64_t b_hi = make_desc(0, SLAB_BOX_BYTES, 1024, 1);
    float acc[PPW][NB * 32];
    int s = 0, cc = 0;
    uint32_t phase = 0;
    // a slab, and at a chunk's end its patch, are released one group late:
    // once the next group is committed and the one that read them is done
    int prev = -1, prev_pb = -1;
    for (int t = blockIdx.x; t < total; t += gridDim.x) {
      const Tile tl = decode_tile<BD, NB>(t, nbd, nbh, nbw, ntiles);
#pragma unroll
      for (int i = 0; i < PPW; ++i)
#pragma unroll
        for (int j = 0; j < NB * 32; ++j) acc[i][j] = 0.f;

      for (int c = 0; c < nchunks; ++c, ++cc) {
        const int pb = cc & 1;
        mbar_wait(full_p + 8 * pb, (cc >> 1) & 1);
        const int ksteps = min(CK, Ci - c * CK) >> 4;  // per tap
        const uint32_t pbase = patch + pb * G::PATCH_BYTES;
        for (int tap0 = 0; tap0 < 27; tap0 += tps) {
          mbar_wait(full_b + 8 * s, phase);
          wgmma_fence();
          uint64_t bd = b_hi | (uint64_t)((ring + s * B_STAGE) >> 4);
          const int tap1 = min(tap0 + tps, 27);
          for (int tap = tap0; tap < tap1; ++tap) {
            const int kd = tap / 9, kh = (tap / 3) % 3, kw = tap % 3;
            const uint64_t a0 =
                a_hi |
                (uint64_t)((pbase +
                            (((wg * PPW + kd) * PH + kh) * PW + kw) * 16) >>
                           4);
            for (int ks = 0; ks < ksteps; ++ks, bd += (16 * 128) >> 4) {
#pragma unroll
              for (int i = 0; i < PPW; ++i) {
                const uint64_t ad =
                    a0 +
                    (uint64_t)(ks * (2 * G::PIECE_BYTES >> 4) + i * (PH * PW));
                wgmma_tile(acc[i], ad, bd);
              }
            }
          }
          wgmma_commit();
          if (prev >= 0) {
            wgmma_wait<1>();  // the previous group has read its operands
            if (lane == 0) {
              mbar_arrive(empty_b + 8 * prev);
              if (prev_pb >= 0) mbar_arrive(empty_p + 8 * prev_pb);
            }
            prev_pb = -1;
          }
          prev = s;
          if (++s == BSTAGES) {
            s = 0;
            phase ^= 1;
          }
        }
        prev_pb = pb;
      }
      wgmma_wait<0>();
      if (lane == 0) {
        mbar_arrive(empty_b + 8 * prev);
        mbar_arrive(empty_p + 8 * prev_pb);
      }
      prev = prev_pb = -1;
#pragma unroll
      for (int i = 0; i < PPW; ++i) fence_acc(acc[i]);

      // accumulator layout of an m64 tile: warp q of the warpgroup holds rows
      // 16q..16q+15; register 4j + 2*half + e is row 16q + lane/4 + 8*half,
      // column 8j + 2*(lane%4) + e. Row r of the tile is voxel (r/8, r%8) of
      // the d-plane. The four lanes of a quad hold the four column pairs of
      // each 8-column group j: a 4x4 transpose inside the quad (two shuffle
      // rounds) gives lane m the whole groups m, m+4, ..., 16 bytes each, so
      // a warp's store covers 64 contiguous bytes of each of 8 rows.
      const int m = lane & 3;
      const int ww = tl.w0 + (lane >> 2);
      if constexpr (STATS) {
        // the values as stored (y's stores below round them again, exactly),
        // rows outside the volume zeroed: they are never stored
#pragma unroll
        for (int i = 0; i < PPW; ++i)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const bool ok = tl.d0 + wg * PPW + i < D &&
                            tl.h0 + 2 * q + half < H && ww < W;
#pragma unroll
            for (int j = 0; j < NB * 8; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                float& a = acc[i][4 * j + 2 * half + e];
                a = ok ? bf16_round(a) : 0.f;
              }
          }
      }
#pragma unroll
      for (int i = 0; i < PPW; ++i) {
        const int dd = tl.d0 + wg * PPW + i;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int hh = tl.h0 + 2 * q + half;
          const bool row_ok = dd < D && hh < H && ww < W;
          __nv_bfloat16* row =
              y + ((((long long)tl.n * D + dd) * H + hh) * W + ww) * Co;
#pragma unroll
          for (int g4 = 0; g4 < NB * 2; ++g4) {  // groups 4*g4 .. 4*g4 + 3
            uint32_t v[4];
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              __nv_bfloat162 pr = __floats2bfloat162_rn(
                  acc[i][4 * (4 * g4 + k) + 2 * half],
                  acc[i][4 * (4 * g4 + k) + 2 * half + 1]);
              v[k] = *reinterpret_cast<uint32_t*>(&pr);
            }
            // round 1, partner m^1: even lanes keep groups 0 and 2 of the
            // lane pair, odd lanes groups 1 and 3
            const bool odd = m & 1;
            const uint32_t r0 =
                __shfl_xor_sync(0xffffffffu, odd ? v[0] : v[1], 1);
            const uint32_t r1 =
                __shfl_xor_sync(0xffffffffu, odd ? v[2] : v[3], 1);
            const uint32_t t0 = odd ? r0 : v[0], t1 = odd ? v[1] : r0;
            const uint32_t t2 = odd ? r1 : v[2], t3 = odd ? v[3] : r1;
            // round 2, partner m^2: lanes 0, 1 end with their first group
            // from all four lanes, lanes 2, 3 with their second
            const bool hi = m & 2;
            const uint32_t s0 = __shfl_xor_sync(0xffffffffu, hi ? t0 : t2, 2);
            const uint32_t s1 = __shfl_xor_sync(0xffffffffu, hi ? t1 : t3, 2);
            const uint4 out = hi ? make_uint4(s0, s1, t2, t3)
                                 : make_uint4(t0, t1, s0, s1);
            const int col = tl.n0 + 8 * (4 * g4 + m);
            if (row_ok && col < Co)
              *reinterpret_cast<uint4*>(row + col) = out;
          }
        }
      }
      if constexpr (STATS)
        box_stats<BD, NB>(acc, red, box_mean, part, tl, N, D, H, W, Co, nbh,
                          nbw, nbd * nbh * nbw, tid, warp, lane);
    }
  }
}

// ---------------------------------------------------------------- host --

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime, so nothing links libcuda
EncodeTiledFn lookup_encode() {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
  cudaError_t err = cudaGetDriverEntryPointByVersion(
      "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &status);
#else
  cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                            cudaEnableDefault, &status);
#endif
  if (err != cudaSuccess || status != cudaDriverEntryPointSuccess)
    return nullptr;
  return reinterpret_cast<EncodeTiledFn>(fn);
}

template <int BD, int NB, bool STATS>
int launch(const CUtensorMap& wmap, const __nv_bfloat16* x, __nv_bfloat16* y,
           float* part, int N, int D, int H, int W, int Ci, int Co, int blocks,
           cudaStream_t s) {
  constexpr int SMEM = smem_bytes<BD, NB, STATS>();
  constexpr int MAX_DEVICES = 64;
  auto kern = conv3d_wgmma_kernel<BD, NB, STATS>;
  // once per instance and device, outside any stream capture
  static bool ready[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return (int)err;
    ready[dev] = true;
  }
  const int nbd = (D + BD - 1) / BD, nbh = (H + BH - 1) / BH,
            nbw = (W + BW - 1) / BW;
  const int ntiles = (Co + NB * 64 - 1) / (NB * 64);
  const long long total = (long long)N * nbd * nbh * nbw * ntiles;
  if (total > 0x7FFF0000LL) return (int)cudaErrorInvalidValue;
  // persistent blocks: the caller's plan gives their number, one per SM of
  // the device (the shared memory admits no second one) or one per tile
  if (blocks < 1 || blocks > total) return (int)cudaErrorInvalidValue;
  if (STATS && (long long)nbd * nbh * nbw > 0x7FFFFFFFLL / Co)
    return (int)cudaErrorInvalidValue;
  kern<<<(unsigned)blocks, THREADS, SMEM, s>>>(wmap, x, y, part, N, D, H, W,
                                              Ci, Co, nbd, nbh, nbw, ntiles,
                                              (int)total);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of the (box_d, bn) instance, 0 for an unknown one.
extern "C" int conv3d_wgmma_smem_bytes(int box_d, int bn) {
  if (box_d == 4 && bn == 64) return smem_bytes<4, 1>();
  if (box_d == 4 && bn == 128) return smem_bytes<4, 2>();
  if (box_d == 2 && bn == 64) return smem_bytes<2, 1>();
  return 0;
}

// The same for the STATS instance.
extern "C" int conv3d_wgmma_stats_smem_bytes(int box_d, int bn) {
  if (box_d == 4 && bn == 64) return smem_bytes<4, 1, true>();
  if (box_d == 4 && bn == 128) return smem_bytes<4, 2, true>();
  if (box_d == 2 && bn == 64) return smem_bytes<2, 1, true>();
  return 0;
}

namespace {

int run(const void* x, const void* w, void* y, float* part, int N, int D,
        int H, int W, int Ci, int Co, int box_d, int bn, int blocks,
        void* stream) {
  if (N < 1 || D < 1 || H < 1 || W < 1 || Ci < 16 || Ci % 16 || Co < 8 ||
      Co % 8 || 27LL * Ci > 0x7FFFFFFFLL ||
      (long long)D * H * W > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  static EncodeTiledFn encode = lookup_encode();
  if (!encode) return (int)cudaErrorNotSupported;
  CUtensorMap wmap;
  const cuuint64_t dims[2] = {(cuuint64_t)Co, (cuuint64_t)27 * Ci};
  const cuuint64_t strides[1] = {(cuuint64_t)Co * 2};
  const cuuint32_t box[2] = {64, CK};
  const cuuint32_t elem[2] = {1, 1};
  if (encode(&wmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(w),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  auto* yb = static_cast<__nv_bfloat16*>(y);
#define CONV3D_WGMMA_INSTANCE(BD, NB)                                        \
  if (box_d == BD && bn == NB * 64)                                          \
    return part ? launch<BD, NB, true>(wmap, xb, yb, part, N, D, H, W, Ci,   \
                                       Co, blocks, s)                        \
                : launch<BD, NB, false>(wmap, xb, yb, nullptr, N, D, H, W,   \
                                        Ci, Co, blocks, s);
  CONV3D_WGMMA_INSTANCE(4, 1)
  CONV3D_WGMMA_INSTANCE(4, 2)
  CONV3D_WGMMA_INSTANCE(2, 1)
#undef CONV3D_WGMMA_INSTANCE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x (N,D,H,W,Ci), w (3,3,3,Ci,Co), y (N,D,H,W,Co): contiguous bf16 on the
// current device, Ci % 16 == 0, Co % 8 == 0. (box_d, bn), the box depth and
// the Co tile, is (4, 64), (4, 128) or (2, 64); `blocks` persistent blocks
// walk the tiles (at most one per tile). Launches on `stream`; returns
// cudaGetLastError() (cudaErrorInvalidValue for a shape or instance it does
// not take, cudaErrorNotSupported where no tensor-map encoder is to be had).
extern "C" int conv3d_wgmma_ndhwc_bf16(const void* x, const void* w, void* y,
                                       int N, int D, int H, int W, int Ci,
                                       int Co, int box_d, int bn, int blocks,
                                       void* stream) {
  return run(x, w, y, nullptr, N, D, H, W, Ci, Co, box_d, bn, blocks, stream);
}

// The same, and the STATS epilogue: `part` is f32 (3, N, boxes, Co), boxes =
// ceil(D / box_d) * ceil(H / 8) * ceil(W / 8) of one sample, box index
// (bd * nbh + bh) * nbw + bw; part[0] the count of the box's voxels inside the
// volume, part[1] their mean, part[2] their centred sum of squares, of the
// bf16 values written to y. Every slot is written.
extern "C" int conv3d_wgmma_stats_ndhwc_bf16(const void* x, const void* w,
                                             void* y, void* part, int N, int D,
                                             int H, int W, int Ci, int Co,
                                             int box_d, int bn, int blocks,
                                             void* stream) {
  if (!part) return (int)cudaErrorInvalidValue;
  return run(x, w, y, static_cast<float*>(part), N, D, H, W, Ci, Co, box_d, bn,
             blocks, stream);
}
