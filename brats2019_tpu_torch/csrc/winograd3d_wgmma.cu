// Winograd F(2x2x2, 3x3x3) conv3d for NDHWC volumes on Hopper tensor cores:
// the same function as winograd3d.cu (SAME, stride 1, no bias; bf16 in, the 64
// per-point products with f32 accumulation, bf16 out; even D, H, W), for
// Ci % 16 == 0 and Co % 8 == 0 (winograd3d.cu stays the general instance).
// Built by brats2019_tpu_torch/ops/_build.py with nvcc -gencode
// arch=compute_90a,code=sm_90a; called through ctypes from
// brats2019_tpu_torch/ops/winograd.py (conv3d_winograd), which plans the launch
// from the shape alone (plan_winograd).
//
// Replaces: brats2019_tpu/ops/pallas_winograd.py conv3d_winograd (:181, kernel
// _kernel :128). The weight transform U = (G x G x G) g runs outside the kernel
// there (an XLA einsum, :87) and here (torch, cached per weight):
//
//   y(2^3 tile) = A^T [ sum_ci  V[p, tile, ci] * U[p, ci, co] ] A,
//   V = B^T d B over the 4^3 input window at (2t-1 .. 2t+2) per axis.
//
// What bounds it on the card: not the tensor cores (8/27 of the direct conv's
// multiply-adds) but what surrounds the products. The mma.sync form
// (winograd3d.cu) spent 80% of its time in the products' own path: U streamed
// from L2 as fragments by every warp, A fragments reloaded per product,
// nothing overlapped. Here U comes from shared memory once per block and chunk
// and the four kinds of work run at once; what then sets the pace is the SM's
// shared memory (128 bytes a clock) and its four instruction schedulers: per
// group of 4 points a block moves ~148 KB through shared memory (the
// products' operands 48 KB, because both consumer warpgroups read the same V;
// the transformer's loads 64 KB, each raw value being read four times; V 16 KB,
// U 16 KB, the raw patch 4 KB) and runs ~270 f32 adds and ~150 packed adds
// through each scheduler. NVIDIA H100 80GB HBM3, 700 W: 10.6 ms for the 24 convs of
// a flagship volume against 44.6 for winograd3d.cu, 7.9 for the direct wgmma
// kernel and 1.46 of bound (tools/torch_conv_check.py --winograd --time); with
// any one of V, the products or A^T left out it takes 51-68% (--probe).
//
//   * M = 64 tiles a block: a brick of 4 x 4 x 4 tiles (8^3 output voxels)
//     whose overlapping windows share one 10^3 raw patch; N = 64 output
//     channels; K advances in chunks of 32 input channels.
//   * Four warpgroups with their own register budgets (setmaxnreg 216 / 56 /
//     24), joined only by mbarrier rings; the block is persistent (one per SM)
//     and every role walks the same (brick, Co tile) list, so the rings run on
//     across tiles:
//       - 96 loader threads fill the raw patch chunk [ci/8][voxel][8 ci] by
//         zero-filling cp.async (halo, ragged bricks and the channel tail read
//         nothing and write zeros); one channel piece per loader, no division
//         by a runtime value per copy. Two patch buffers.
//       - one thread streams U by TMA: a 3-D map over (64, CiP, CoP) with
//         128-byte swizzle, one slab of 4 points x 32 ci x 64 co per step, a
//         ring of 3 slabs (about 1,200 clocks from request to arrival, so the
//         ring's 48 KB bound a group at ~400 clocks).
//       - a transformer warpgroup makes V in packed bf16 (the reference's
//         _bt4 also runs on the bf16 values), 8 channels a thread and step:
//         for one (d-point, h-point) it combines two planes and two rows of the
//         patch (a row's 8 loads in flight together) and writes the 4 w-points
//         as wgmma's K-major no-swizzle A operand [point][ci/8][tile][8 ci] into
//         a ring of 3 buffers, behind a proxy fence. Packed adds are half the
//         f32 form's instructions and need no conversions. Form (a) of the two
//         possible (V through shared memory, not made in the consumers'
//         registers): both consumer warpgroups read the same V, and the A
//         fragments of 4 points x 2 k-steps plus the transform's temporaries do
//         not fit beside 192 accumulator registers.
//       - two consumer warpgroups, one 32-channel half of N each
//         (m64n32k16, B at a 64-byte offset inside the swizzled 128-byte row):
//         per slab 4 points x 2 k-steps into 4 product accumulators, then A^T:
//         the 4 w-points fold to 2 in place (4 updates), and each is
//         sign-added into the output phases its (d, h) point feeds. 136
//         accumulator updates per group instead of 216; the 64-point M tensor
//         never exists. 8 phases x 16 + 4 x 16 accumulator registers a thread.
//         The warpgroups take turns (two named barriers), so one's products
//         run while the other folds.
//   * Tried and taken out again (each right, each slower): A^T along w folded
//     into the contraction (two products of K = 96 from v0, v1, v2, -v2, -v3:
//     the adds vanish behind the products but the operands' traffic grows by
//     half, 11.6 ms); the next group's products started before this group's
//     fold (two accumulator sets: ptxas spilled the phases, 18-23 ms).
//   * Shared memory: U ring 48 KB + 2 patches 125 KB + V ring 51 KB = 225 KB.
//   * Epilogue: phases -> bf16, a 4x4 transpose inside each lane quad, 16-byte
//     stores (a quad covers the 64 contiguous bytes of its half of N); tiles
//     past the volume and channels past Co are masked.
//   * One fixed summation order, no atomics: repeat runs are bitwise equal.
//   * The waits are bare loops: a clock and a trap inside each of the
//     consumers' 32 waits a chunk made ptxas keep the phases in local memory
//     (2.8 KB of spills, 2x the time). One thread, the one that streams U,
//     watches for all: every ring hangs together, so its waits (and a last one
//     for the consumers' end) trap after 20 s of the card's clock instead of
//     hanging the card.

// Probe builds, for timing only (tools/torch_conv_check.py --winograd --probe):
// -DWINOGRAD_PROBE=bits leaves out 1: the loaders' copies, 2: the making of V,
// 4: the products, 8: the A^T updates.
#ifndef WINOGRAD_PROBE
#define WINOGRAD_PROBE 0
#endif

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TT = 4;                    // tiles per brick along d, h and w
constexpr int BT = TT * TT * TT;         // 64 tiles: the product's M
constexpr int PP = 2 * TT + 2;           // raw patch extent per axis
constexpr int NVOX = PP * PP * PP;       // 1000 voxels
constexpr int CK = 32;                   // input channels per chunk
constexpr int NPIECE = CK / 8;           // 16-byte channel pieces per chunk
constexpr int BN = 64;                   // output channels per block
constexpr int GP = 4;                    // points per group: the 4 w-points
constexpr int NGROUP = 16;               // (d-point, h-point) groups
constexpr int RSTAGES = 2;               // raw patch buffers
constexpr int VSTAGES = 3;               // V buffers
constexpr int USTAGES = 3;               // U slabs
constexpr int RAW_PIECE_BYTES = (NVOX + 1) * 16;  // odd pitch in 16-byte units
constexpr int RAW_BYTES = NPIECE * RAW_PIECE_BYTES;
constexpr int V_PIECE_BYTES = BT * 16 + 64;       // pitch = 4 mod 8 units
constexpr int V_POINT_BYTES = NPIECE * V_PIECE_BYTES;
constexpr int V_BYTES = GP * V_POINT_BYTES;
constexpr int U_POINT_BYTES = CK * BN * 2;        // 32 rows of 128 bytes
constexpr int U_BYTES = GP * U_POINT_BYTES;
constexpr int NBARS = 2 * USTAGES + 2 * VSTAGES + 2 * RSTAGES + 1;
constexpr int SMEM_BYTES = 1024 + USTAGES * U_BYTES + RSTAGES * RAW_BYTES +
                           VSTAGES * V_BYTES + 8 * NBARS;

// byte offsets from the 1024-aligned base of the dynamic shared memory
constexpr int OFF_RAW = USTAGES * U_BYTES;
constexpr int OFF_V = OFF_RAW + RSTAGES * RAW_BYTES;
constexpr int OFF_FULL_U = OFF_V + VSTAGES * V_BYTES;
constexpr int OFF_EMPTY_U = OFF_FULL_U + 8 * USTAGES;
constexpr int OFF_FULL_V = OFF_EMPTY_U + 8 * USTAGES;
constexpr int OFF_EMPTY_V = OFF_FULL_V + 8 * VSTAGES;
constexpr int OFF_FULL_R = OFF_EMPTY_V + 8 * VSTAGES;
constexpr int OFF_EMPTY_R = OFF_FULL_R + 8 * RSTAGES;
constexpr int OFF_DONE = OFF_EMPTY_R + 8 * RSTAGES;

constexpr int THREADS = 512;             // 4 warpgroups
constexpr int CONSUMER_WARPS = 8;        // warpgroups 0 and 1
constexpr int XFORM_THREADS = 128;       // warpgroup 2
constexpr int LOADERS = 96;              // warps 13..15; warp 12 lane 0 is TMA
// registers a thread after setmaxnreg; 128 * (2 * 216 + 56 + 24) = 65536 (the
// host checks the sum against what the block holds at launch). The consumers
// need ~25 beside their 192 accumulators.
constexpr int REGS_CONSUMER = 216, REGS_XFORM = 56, REGS_PRODUCER = 24;

constexpr unsigned long long WAIT_LIMIT_NS = 20ull * 1000 * 1000 * 1000;
constexpr int SPIN_CHECK = 1 << 16;

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
__device__ __forceinline__ uint32_t mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done;
}
// wait until the phase of parity `parity` has completed. A bare loop: in the
// consumers a clock and a trap inside each of the 32 waits of a chunk cost the
// register allocation dearly, so one thread watches for all (mbar_wait_watch).
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}
// the same for the one thread that streams U: it traps once a wait has lasted
// WAIT_LIMIT_NS. Every ring of the block hangs together (the consumers stop
// releasing U slabs when any producer stops), so this thread's waits, and its
// last one for the consumers' end, see any wrong barrier phase in the block.
// The clock is read once in SPIN_CHECK polls.
__device__ __forceinline__ void mbar_wait_watch(uint32_t bar, uint32_t parity) {
  int spins = 0;
  unsigned long long t0 = 0;
  while (!mbar_try_wait(bar, parity)) {
    if (++spins == SPIN_CHECK) {
      spins = 0;
      unsigned long long now;
      asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(now));
      if (!t0) t0 = now;
      if (now - t0 > WAIT_LIMIT_NS) __trap();
    }
  }
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  int n = valid ? 16 : 0;  // src-size 0: write 16 zero bytes, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
// named barriers 1 and 2 order the two consumer warpgroups' products
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
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
__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}
__device__ __forceinline__ void sts128(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// D(64 x 32, f32) (+)= A(64 x 16, K-major, no swizzle) * B(16 x 32, MN-major,
// 128B swizzle), both from shared memory; accumulate == 0 overwrites D
__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[16], uint64_t a,
                                                uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

// keeps the compiler from moving reads of the accumulators across the wait
// that completes the asynchronous products
__device__ __forceinline__ void fence_acc(float (&d)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// shared-memory matrix descriptor: start address, leading and stride byte
// offsets in 16-byte units, layout (0 none, 1 128-byte swizzle)
__host__ __device__ constexpr uint64_t make_desc(uint32_t addr, uint32_t lbo_bytes,
                                              uint32_t sbo_bytes,
                                              uint32_t layout) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(lbo_bytes >> 4) << 16) |
         ((uint64_t)(sbo_bytes >> 4) << 32) | ((uint64_t)layout << 62);
}

// ---------------------------------------------------------- transforms --

// A^T = [[1, 1, 1, 0], [0, 1, -1, -1]]
__host__ __device__ constexpr int at_coef(int s, int i) {
  return s == 0 ? (i < 3 ? 1 : 0) : (i == 0 ? 0 : (i == 1 ? 1 : -1));
}
// B^T row i reads taps (bt_a(i), bt_b(i)): t0 - t2, t1 + t2, t2 - t1, t1 - t3
__host__ __device__ constexpr int bt_a(int i) { return i == 0 ? 0 : (i == 2 ? 2 : 1); }
__host__ __device__ constexpr int bt_b(int i) {
  return i == 0 ? 2 : (i == 1 ? 2 : (i == 2 ? 1 : 3));
}

__device__ __forceinline__ uint32_t add2(uint32_t a, uint32_t b) {
  __nv_bfloat162 r = __hadd2(*reinterpret_cast<__nv_bfloat162*>(&a),
                             *reinterpret_cast<__nv_bfloat162*>(&b));
  return *reinterpret_cast<uint32_t*>(&r);
}
__device__ __forceinline__ uint32_t sub2(uint32_t a, uint32_t b) {
  __nv_bfloat162 r = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&a),
                             *reinterpret_cast<__nv_bfloat162*>(&b));
  return *reinterpret_cast<uint32_t*>(&r);
}
// 8 channels at once: a + b where ADD, else a - b (each op rounds to bf16)
template <bool ADD>
__device__ __forceinline__ uint4 comb(uint4 a, uint4 b) {
  return ADD ? make_uint4(add2(a.x, b.x), add2(a.y, b.y), add2(a.z, b.z),
                          add2(a.w, b.w))
             : make_uint4(sub2(a.x, b.x), sub2(a.y, b.y), sub2(a.z, b.z),
                          sub2(a.w, b.w));
}

// V of one (tile, channel piece) for d-point P and h-point Q, its 4 w-points
// stored at vdst + r * V_POINT_BYTES. `src` is the window's first voxel in the
// raw piece.
template <int P, int Q>
__device__ __forceinline__ void make_v(uint32_t src, uint32_t vdst) {
  // a row's 8 loads first, so they are in flight together
  uint4 row[2][4];  // [row of Q][window voxel along w], B^T along d applied
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    uint4 x[2][4];  // [plane of P][window voxel along w]
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        x[a][c] = lds128(src + (((a == 0 ? bt_a(P) : bt_b(P)) * PP +
                                 (k == 0 ? bt_a(Q) : bt_b(Q))) *
                                    PP +
                                c) *
                                   16);
#pragma unroll
    for (int c = 0; c < 4; ++c) row[k][c] = comb<P == 1>(x[0][c], x[1][c]);
  }
  uint4 h[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) h[c] = comb<Q == 1>(row[0][c], row[1][c]);
  sts128(vdst, comb<false>(h[0], h[2]));
  sts128(vdst + V_POINT_BYTES, comb<true>(h[1], h[2]));
  sts128(vdst + 2 * V_POINT_BYTES, comb<false>(h[2], h[1]));
  sts128(vdst + 3 * V_POINT_BYTES, comb<false>(h[1], h[3]));
}

// ------------------------------------------------------------- kernel --

// one output tile: a brick of one sample and a Co tile
struct Tile {
  int n, td0, th0, tw0, n0;
};
__device__ __forceinline__ Tile decode_tile(int t, int nbd, int nbh, int nbw,
                                            int ntiles) {
  Tile r;
  r.n0 = (t % ntiles) * BN;  // Co tiles of one brick run side by side
  t /= ntiles;
  r.tw0 = (t % nbw) * TT;
  t /= nbw;
  r.th0 = (t % nbh) * TT;
  t /= nbh;
  r.td0 = (t % nbd) * TT;
  r.n = t / nbd;
  return r;
}

// the transformer's 16 groups of one chunk; G = P * 4 + Q
template <int G>
struct XformGroups {
  static __device__ __forceinline__ void run(uint32_t src0, uint32_t src1,
                                             uint32_t vring, uint32_t vofs0,
                                             uint32_t vofs1, uint32_t full_v,
                                             uint32_t empty_v, int lane,
                                             int& s, uint32_t& phase) {
    mbar_wait(empty_v + 8 * s, phase ^ 1);
    const uint32_t vb = vring + s * V_BYTES;
    if (!(WINOGRAD_PROBE & 2)) {
      make_v<G / 4, G % 4>(src0, vb + vofs0);
      make_v<G / 4, G % 4>(src1, vb + vofs1);
    }
    fence_proxy_async();  // wgmma reads V through the async proxy
    __syncwarp();
    if (lane == 0) mbar_arrive(full_v + 8 * s);  // one arrival a warp
    if (++s == VSTAGES) {
      s = 0;
      phase ^= 1;
    }
    XformGroups<G + 1>::run(src0, src1, vring, vofs0, vofs1, full_v, empty_v,
                            lane, s, phase);
  }
};
template <>
struct XformGroups<NGROUP> {
  static __device__ __forceinline__ void run(uint32_t, uint32_t, uint32_t,
                                             uint32_t, uint32_t, uint32_t,
                                             uint32_t, int, int&, uint32_t&) {}
};

// the consumer's 16 groups of one chunk: the 4 w-points' products (2 k-steps
// each) into 4 accumulators, A^T along w in place, then the sign-adds into
// the phases. The two warpgroups take turns (named barriers 1 and 2), so
// one's products run on the tensor cores while the other folds its last ones.
template <int G>
struct ProductGroups {
  // base: the shared memory's aligned base; b_ofs: the warpgroup's half of N
  // as bytes into a U row; (vs, vph), (us, uph): this group's V buffer and U
  // slab with the parities of their current use
  static __device__ __forceinline__ void run(float (&ph)[8][16], uint32_t base,
                                             uint32_t b_ofs, int lane, int wg,
                                             int& vs, uint32_t& vph, int& us,
                                             uint32_t& uph) {
    constexpr int P = G / 4, Q = G % 4;
    float m[GP][16];
    mbar_wait(base + OFF_FULL_V + 8 * vs, vph);
    mbar_wait(base + OFF_FULL_U + 8 * us, uph);
    if (WINOGRAD_PROBE & 4) {  // values the compiler cannot fold
#pragma unroll
      for (int r = 0; r < GP; ++r)
#pragma unroll
        for (int i = 0; i < 16; ++i) m[r][i] = (float)(lane + r);
    }
    bar_sync(1 + wg);
    wgmma_fence();
    const uint32_t vb = base + OFF_V + vs * V_BYTES;
    const uint32_t ub = base + us * U_BYTES + b_ofs;
    const uint64_t a_hi = make_desc(0, V_PIECE_BYTES, 128, 0);
    const uint64_t b_hi = make_desc(0, U_POINT_BYTES, 1024, 1);
#pragma unroll
    for (int r = 0; r < GP; ++r)
#pragma unroll
      for (int ks = (WINOGRAD_PROBE & 4) ? CK : 0; ks < CK / 16; ++ks) {
        const uint64_t ad =
            a_hi |
            (uint64_t)((vb + r * V_POINT_BYTES + ks * 2 * V_PIECE_BYTES) >> 4);
        const uint64_t bd =
            b_hi | (uint64_t)((ub + r * U_POINT_BYTES + ks * 16 * 128) >> 4);
        wgmma_m64n32k16(m[r], ad, bd, ks);
      }
    wgmma_commit();
    bar_arrive(2 - wg);
    wgmma_wait<0>();
    if (lane == 0) {  // the products have read their operands
      mbar_arrive(base + OFF_EMPTY_V + 8 * vs);
      mbar_arrive(base + OFF_EMPTY_U + 8 * us);
    }
    if (++vs == VSTAGES) {
      vs = 0;
      vph ^= 1;
    }
    if (++us == USTAGES) {
      us = 0;
      uph ^= 1;
    }
#pragma unroll
    for (int r = 0; r < GP; ++r) fence_acc(m[r]);
    if (!(WINOGRAD_PROBE & 8)) {
      // A^T along w in place: m[0] = m0 + m1 + m2, m[1] = m1 - m2 - m3
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        m[0][i] += m[1][i];
        m[0][i] += m[2][i];
        m[1][i] -= m[2][i];
        m[1][i] -= m[3][i];
      }
    }
    // then along d and h: sign-add into the phases this (P, Q) feeds
#pragma unroll
    for (int sd = 0; sd < 2; ++sd)
#pragma unroll
      for (int sh = 0; sh < 2; ++sh) {
        const int coef = (WINOGRAD_PROBE & 8)
                             ? (sd == 0 && sh == 0 && G == 0)
                             : at_coef(sd, P) * at_coef(sh, Q);
        if (coef > 0) {
#pragma unroll
          for (int i = 0; i < 16; ++i) {
            ph[sd * 4 + sh * 2][i] += m[0][i];
            ph[sd * 4 + sh * 2 + 1][i] += m[1][i];
          }
        } else if (coef < 0) {
#pragma unroll
          for (int i = 0; i < 16; ++i) {
            ph[sd * 4 + sh * 2][i] -= m[0][i];
            ph[sd * 4 + sh * 2 + 1][i] -= m[1][i];
          }
        }
      }
    ProductGroups<G + 1>::run(ph, base, b_ofs, lane, wg, vs, vph, us, uph);
  }
};
template <>
struct ProductGroups<NGROUP> {
  static __device__ __forceinline__ void run(float (&)[8][16], uint32_t,
                                             uint32_t, int, int, int&,
                                             uint32_t&, int&, uint32_t&) {}
};

__global__ void __launch_bounds__(THREADS, 1)
    winograd_wgmma_kernel(const __grid_constant__ CUtensorMap umap,
                          const __nv_bfloat16* __restrict__ x,
                          __nv_bfloat16* __restrict__ y, int D, int H, int W,
                          int Ci, int Co, int nbd, int nbh, int nbw, int ntiles,
                          int total) {
  extern __shared__ unsigned char smem_raw[];
  // the swizzled slabs want 1024-byte alignment
  const uint32_t uring =
      ((uint32_t)__cvta_generic_to_shared(smem_raw) + 1023u) & ~1023u;
  const uint32_t raw = uring + OFF_RAW;
  const uint32_t vring = uring + OFF_V;
  const uint32_t full_u = uring + OFF_FULL_U;
  const uint32_t empty_u = uring + OFF_EMPTY_U;
  const uint32_t full_v = uring + OFF_FULL_V;
  const uint32_t empty_v = uring + OFF_EMPTY_V;
  const uint32_t full_r = uring + OFF_FULL_R;
  const uint32_t empty_r = uring + OFF_EMPTY_R;

  const int tid = threadIdx.x;
  // through a shuffle, so the compiler knows the role branches below are
  // warp-uniform (else it serialises the wgmmas as if in a divergent path)
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int lane = tid & 31;
  const int nchunks = (Ci + CK - 1) / CK;

  if (tid == 0) {
    for (int i = 0; i < USTAGES; ++i) {
      mbar_init(full_u + 8 * i, 1);
      mbar_init(empty_u + 8 * i, CONSUMER_WARPS);
    }
    for (int i = 0; i < VSTAGES; ++i) {
      mbar_init(full_v + 8 * i, XFORM_THREADS / 32);
      mbar_init(empty_v + 8 * i, CONSUMER_WARPS);
    }
    for (int i = 0; i < RSTAGES; ++i) {
      mbar_init(full_r + 8 * i, LOADERS / 32);
      mbar_init(empty_r + 8 * i, XFORM_THREADS / 32);
    }
    mbar_init(uring + OFF_DONE, CONSUMER_WARPS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= CONSUMER_WARPS + 4) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(REGS_PRODUCER));
    if (warp == CONSUMER_WARPS + 4) {
      // ---- U slabs by TMA, one thread
      if (lane == 0) {
        int s = 0;
        uint32_t phase = 0;
        for (int t = blockIdx.x; t < total; t += gridDim.x) {
          const int n0 = (t % ntiles) * BN;
          for (int c = 0; c < nchunks; ++c)
            for (int g = 0; g < NGROUP; ++g) {
              mbar_wait_watch(empty_u + 8 * s, phase ^ 1);
              mbar_arrive_expect_tx(full_u + 8 * s, U_BYTES);
              tma_load_3d(uring + s * U_BYTES, &umap, full_u + 8 * s, n0, c * CK,
                          g * GP);
              if (++s == USTAGES) {
                s = 0;
                phase ^= 1;
              }
            }
        }
        mbar_wait_watch(uring + OFF_DONE, 0);  // until the consumers have ended

      }
    } else {
      // ---- the raw patch by zero-filling cp.async, 96 threads: a thread
      // keeps one channel piece and walks the voxels in steps of 24
      const int lt = tid - (CONSUMER_WARPS + 5) * 32;
      const int j = lt & (NPIECE - 1);
      int cc = 0;  // chunks so far: buffer cc & 1, its use number cc >> 1
      for (int t = blockIdx.x; t < total; t += gridDim.x) {
        const Tile tl = decode_tile(t, nbd, nbh, nbw, ntiles);
        const __nv_bfloat16* xn = x + (long long)tl.n * D * H * W * Ci;
        const int d0 = 2 * tl.td0 - 1, h0 = 2 * tl.th0 - 1, w0 = 2 * tl.tw0 - 1;
        for (int c = 0; c < nchunks; ++c, ++cc) {
          const int rb = cc & 1;
          mbar_wait(empty_r + 8 * rb, ((cc >> 1) & 1) ^ 1);
          const int ci = c * CK + j * 8;
          const bool piece_ok = ci < Ci;
          const uint32_t dst0 = raw + rb * RAW_BYTES + j * RAW_PIECE_BYTES;
          const __nv_bfloat16* xc = xn + ci;
#pragma unroll 4
          for (int v = lt >> 2; v < NVOX; v += LOADERS / NPIECE) {
            const int a = v / (PP * PP);
            const int rem = v - a * (PP * PP);
            const int bb = rem / PP;
            const int cw = rem - bb * PP;
            const int dd = d0 + a, hh = h0 + bb, ww = w0 + cw;
            const bool ok = piece_ok && dd >= 0 && dd < D && hh >= 0 && hh < H &&
                            ww >= 0 && ww < W;
            const long long src = (long long)((dd * H + hh) * W + ww) * Ci;
            if (!(WINOGRAD_PROBE & 1))
              cp_async16(dst0 + v * 16,
                         ok ? (const void*)(xc + src) : (const void*)x, ok);
          }
          asm volatile("cp.async.wait_all;\n" ::: "memory");
          __syncwarp();
          if (lane == 0) mbar_arrive(full_r + 8 * rb);
        }
      }
    }
  } else if (warp >= CONSUMER_WARPS) {
    // ---- V = B^T d B in packed bf16, 128 threads. Thread xt owns tile column
    // iw, channel piece j, tile row ih and the two tile planes id and id + 2.
    // A quarter warp (4 iw x 2 j) reads 8 different 16-byte bank groups of
    // the raw patch (voxel stride 2, odd piece pitch) and writes 8 of V.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(REGS_XFORM));
    const int xt = tid - CONSUMER_WARPS * 32;
    const int iw = xt & 3, j = (xt >> 2) & 3, ih = (xt >> 4) & 3, id = xt >> 6;
    const uint32_t sofs0 =
        j * RAW_PIECE_BYTES + (((2 * id) * PP + 2 * ih) * PP + 2 * iw) * 16;
    const uint32_t sofs1 = sofs0 + 4 * PP * PP * 16;  // tile plane id + 2
    const uint32_t vofs0 = j * V_PIECE_BYTES + ((id * TT + ih) * TT + iw) * 16;
    const uint32_t vofs1 = vofs0 + 2 * TT * TT * 16;
    int s = 0, cc = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < total; t += gridDim.x) {
      for (int c = 0; c < nchunks; ++c, ++cc) {
        const int rb = cc & 1;
        mbar_wait(full_r + 8 * rb, (cc >> 1) & 1);
        const uint32_t rbase = raw + rb * RAW_BYTES;
        XformGroups<0>::run(rbase + sofs0, rbase + sofs1, vring, vofs0, vofs1,
                            full_v, empty_v, lane, s, phase);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty_r + 8 * rb);  // the warp has read it
      }
    }

  } else {
    // ---- products and A^T: two warpgroups, one 32-channel half of N each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REGS_CONSUMER));
    const int wg = warp >> 2;
    const int q = warp & 3;
    // the half's 32 channels start 64 bytes into each swizzled 128-byte row
    const uint32_t b_ofs = wg * 64;
    int vs = 0, us = 0;
    uint32_t vph = 0, uph = 0;
    const int Td = D / 2, Th = H / 2, Tw = W / 2;
    float ph[8][16];   // output phase sd * 4 + sh * 2 + sw
    if (wg == 1) bar_arrive(1);  // warpgroup 0 goes first
    for (int t = blockIdx.x; t < total; t += gridDim.x) {
      const Tile tl = decode_tile(t, nbd, nbh, nbw, ntiles);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int k = 0; k < 16; ++k) ph[i][k] = 0.f;

      for (int c = 0; c < nchunks; ++c)
        ProductGroups<0>::run(ph, uring, b_ofs, lane, wg, vs, vph, us, uph);

      // accumulator layout of an m64 tile: warp q of the warpgroup holds rows
      // 16q..16q+15; register 4j + 2*half + e is row 16q + lane/4 + 8*half,
      // column 8j + 2*(lane%4) + e. Row r is tile (r/16, (r/4)%4, r%4) of the
      // brick. A 4x4 transpose inside the quad (two shuffle rounds) gives lane
      // m the whole 8-column group m, 16 bytes, so a quad's store covers the
      // 64 contiguous bytes of its half of N.
      const int mq = lane & 3;
      const int col = tl.n0 + wg * 32 + 8 * mq;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = 16 * q + (lane >> 2) + 8 * half;
        const int td = tl.td0 + (r >> 4), th = tl.th0 + ((r >> 2) & 3),
                  tw = tl.tw0 + (r & 3);
        const bool row_ok = td < Td && th < Th && tw < Tw;
        __nv_bfloat16* tile0 =
            y + ((((long long)tl.n * D + 2 * td) * H + 2 * th) * W + 2 * tw) * Co +
            col;
#pragma unroll
        for (int p8 = 0; p8 < 8; ++p8) {
          uint32_t v[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            __nv_bfloat162 pr = __floats2bfloat162_rn(
                ph[p8][4 * k + 2 * half], ph[p8][4 * k + 2 * half + 1]);
            v[k] = *reinterpret_cast<uint32_t*>(&pr);
          }
          // round 1, partner m^1: even lanes keep groups 0 and 2 of the lane
          // pair, odd lanes groups 1 and 3
          const bool odd = mq & 1;
          const uint32_t r0 = __shfl_xor_sync(0xffffffffu, odd ? v[0] : v[1], 1);
          const uint32_t r1 = __shfl_xor_sync(0xffffffffu, odd ? v[2] : v[3], 1);
          const uint32_t t0 = odd ? r0 : v[0], t1 = odd ? v[1] : r0;
          const uint32_t t2 = odd ? r1 : v[2], t3 = odd ? v[3] : r1;
          // round 2, partner m^2: lanes 0, 1 end with their first group from
          // all four lanes, lanes 2, 3 with their second
          const bool hi = mq & 2;
          const uint32_t s0 = __shfl_xor_sync(0xffffffffu, hi ? t0 : t2, 2);
          const uint32_t s1 = __shfl_xor_sync(0xffffffffu, hi ? t1 : t3, 2);
          const uint4 out =
              hi ? make_uint4(s0, s1, t2, t3) : make_uint4(t0, t1, s0, s1);
          const long long ofs =
              ((long long)((p8 >> 2) * H + ((p8 >> 1) & 1)) * W + (p8 & 1)) * Co;
          if (row_ok && col < Co) *reinterpret_cast<uint4*>(tile0 + ofs) = out;
        }
      }
    }
    if (wg == 0) bar_sync(1);  // takes warpgroup 1's last arrival
    if (lane == 0) mbar_arrive(uring + OFF_DONE);
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

}  // namespace

// Dynamic shared memory of the kernel.
extern "C" int winograd3d_wgmma_smem_bytes() { return SMEM_BYTES; }

// x (N,D,H,W,Ci), y (N,D,H,W,Co): contiguous bf16 on the current device,
// D, H, W even, Ci % 16 == 0, Co % 8 == 0. u (64, CiP, CoP): the transformed
// weight, bf16, zero-padded to CiP % 32 == 0 >= Ci and CoP % 64 == 0 >= Co.
// `blocks` persistent blocks walk the (brick, Co tile) list (at most one per
// entry). Launches on `stream`; returns cudaGetLastError()
// (cudaErrorInvalidValue for a shape it does not take, cudaErrorNotSupported
// where no tensor-map encoder is to be had).
extern "C" int winograd3d_wgmma_ndhwc_bf16(const void* x, const void* u, void* y,
                                           int N, int D, int H, int W, int Ci,
                                           int Co, int CiP, int CoP, int blocks,
                                           void* stream) {
  if (N < 1 || D < 2 || H < 2 || W < 2 || (D | H | W) & 1 || Ci < 16 ||
      Ci % 16 || Co < 8 || Co % 8 || CiP % CK || CoP % BN || CiP < Ci ||
      CoP < Co || (long long)D * H * W > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  static EncodeTiledFn encode = lookup_encode();
  if (!encode) return (int)cudaErrorNotSupported;
  CUtensorMap umap;
  const cuuint64_t dims[3] = {(cuuint64_t)CoP, (cuuint64_t)CiP, 64};
  const cuuint64_t strides[2] = {(cuuint64_t)CoP * 2,
                                 (cuuint64_t)CiP * CoP * 2};
  const cuuint32_t box[3] = {BN, CK, GP};
  const cuuint32_t elem[3] = {1, 1, 1};
  if (encode(&umap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(u),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;

  constexpr int MAX_DEVICES = 64;
  static bool ready[MAX_DEVICES] = {};  // once per device, outside any capture
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(winograd_wgmma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    // setmaxnreg.inc waits for registers the other warpgroups gave back: the
    // budgets must fit what the block was given at launch, or it would hang
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, winograd_wgmma_kernel);
    if (err != cudaSuccess) return (int)err;
    if (4 * attr.numRegs < 2 * REGS_CONSUMER + REGS_XFORM + REGS_PRODUCER)
      return (int)cudaErrorLaunchOutOfResources;
    ready[dev] = true;
  }
  const int nbd = (D / 2 + TT - 1) / TT, nbh = (H / 2 + TT - 1) / TT,
            nbw = (W / 2 + TT - 1) / TT;
  const int ntiles = CoP / BN;
  const long long total = (long long)N * nbd * nbh * nbw * ntiles;
  if (total > 0x7FFF0000LL || blocks < 1 || blocks > total)
    return (int)cudaErrorInvalidValue;
  winograd_wgmma_kernel<<<(unsigned)blocks, THREADS, SMEM_BYTES,
                          static_cast<cudaStream_t>(stream)>>>(
      umap, static_cast<const __nv_bfloat16*>(x),
      static_cast<__nv_bfloat16*>(y), D, H, W, Ci, Co, nbd, nbh, nbw, ntiles,
      (int)total);
  return (int)cudaGetLastError();
}
