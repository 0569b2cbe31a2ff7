// Exact 2x trilinear upsample of NDHWC volumes on Hopper and its transpose,
// in bf16 and f32: half-pixel taps (0.25, 0.75) with replicate-clamped edges,
// f32 math, out in the input's type (bf16: round to nearest even); and the 2x
// down (2^3 average) and its transpose in f32. Built by
// brats2019_tpu_torch/ops/_build.py with nvcc -gencode
// arch=compute_90a,code=sm_90a; called through ctypes from
// brats2019_tpu_torch/ops/resize.py (upsample2x_kernel, upsample2x_concat,
// downsample2x_kernel, upsample2x_bwd_kernel, downsample2x_bwd_kernel). The
// up comes first, then the down, then the up's backward, then the down's.
//
// Replaces: brats2019_tpu/ops/pallas_resize.py upsample2x_pallas (:103,
// kernel _up_fwd_kernel :82). Per axis, out[2i] = 0.25 x[i-1] + 0.75 x[i] and
// out[2i+1] = 0.75 x[i] + 0.25 x[i+1], with x[-1] = x[0] and x[n] = x[n-1].
//
// What bounds it on the card: device-memory bytes. Each input value is read
// once and fans out to 8 outputs, so the write of y is 8/9 of the traffic;
// a handful of flops per output. What held the Triton gather kernel
// (ops/triton_resize.py _up2x_kernel) at a quarter of that bound was the
// instruction stream: per output element 8 scalar gathers and a runtime
// division by C. The design:
//
//   * A block owns a TD x TH x TW = 4 x 4 x 8 tile of input voxels of one
//     sample and one chunk of 8 pieces of 16 bytes (64 bf16 or 32 f32
//     channels). It brings the tile and its 1-voxel halo (6 x 6 x 10 voxels,
//     46,080 bytes) into shared memory with 16-byte cp.async at CLAMPED
//     addresses: a halo voxel past a face is a copy of the face voxel, which
//     is the replicate clamp itself (TMA's out-of-bounds fill is zeros, so it
//     does not fit).
//   * Thread (h, w, piece) walks the tile's d column: for each halo d-row it
//     interpolates along w (3 taps), then h (3 rows) from shared memory into
//     the 2 x 2 (h, w) output phases of that row, one piece each; two rows
//     at a time stay in registers, and each new row completes the odd d-phase
//     of the voxel before it and the even d-phase of its own, so every
//     (w, h)-interpolated row is computed once per tile, not three times.
//   * Each output piece is written by one 16-byte store; a warp's store
//     covers 4 voxels x 128 contiguous bytes.
//   * The output has a channel pitch and offset, so the kernel writes
//     straight into the up half [..., :C] of the decoder's (up, skip) concat
//     buffer: the concat does not copy the upsampled tensor a second time.
//   * The two element types share the code (upsample2x_kernel<T>): the math
//     is f32 in one tap order in both; only the pieces' unpacking and packing
//     differ (8 bf16 channels rounded at the store, or 4 f32 channels stored
//     as computed).
//   * Any D, H, W >= 1 (at extent 1 every tap lands on the one voxel), any C
//     that fills whole pieces (bf16 C % 8 == 0, f32 C % 4 == 0; a chunk of
//     fewer than 8 pieces leaves threads idle); other C go to the Triton
//     kernel, chosen by shape in resize.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TD = 4, TH = 4, TW = 8;                   // input voxels of a tile
constexpr int HD = TD + 2, HH = TH + 2, HW = TW + 2;    // with the halo
constexpr int PIECES = 8;                               // 16-byte pieces of a chunk
constexpr int THREADS = TH * TW * PIECES;               // one (h, w, piece) each
constexpr int HALO = HD * HH * HW * PIECES;             // 16-byte slots
static_assert(HALO * 16 <= 48 * 1024, "static shared memory");

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void unpack8(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    f[2 * k] = __uint_as_float(w[k] << 16);
    f[2 * k + 1] = __uint_as_float(w[k] & 0xFFFF0000u);
  }
}

__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    __nv_bfloat162 p = __floats2bfloat162_rn(f[2 * k], f[2 * k + 1]);
    w[k] = *reinterpret_cast<uint32_t*>(&p);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// A 16-byte piece of channels: 8 bf16 or 4 f32, unpacked to and packed from
// f32.
template <typename T>
struct Piece;

template <>
struct Piece<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void unpack(const uint4& u, float (&f)[N]) {
    unpack8(u, f);
  }
  static __device__ __forceinline__ uint4 pack(const float (&f)[N]) {
    return pack8(f);
  }
};

template <>
struct Piece<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void unpack(const uint4& u, float (&f)[N]) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  static __device__ __forceinline__ uint4 pack(const float (&f)[N]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

// One halo d-row r of this thread's column, interpolated along w then h:
// o[b][e] is the (2h + b, 2w + e) output phase, one piece of channels. The h
// taps are folded in as they come, so one tap's w phases are live at a time.
template <typename T>
__device__ __forceinline__ void row_hw(const uint4* tile, int r, int lh, int lw,
                                       int p, float (&o)[2][2][Piece<T>::N]) {
  constexpr int E = Piece<T>::N;
#pragma unroll
  for (int hn = 0; hn < 3; ++hn) {
    const uint4* s = tile + (((r * HH + lh + hn) * HW + lw) * PIECES + p);
    float a[E], b[E], c[E];
    Piece<T>::unpack(s[0], a);
    Piece<T>::unpack(s[PIECES], b);
    Piece<T>::unpack(s[2 * PIECES], c);
#pragma unroll
    for (int k = 0; k < E; ++k) {
      const float we = 0.25f * a[k] + 0.75f * b[k];
      const float wo = 0.75f * b[k] + 0.25f * c[k];
      if (hn == 0) {
        o[0][0][k] = 0.25f * we;
        o[0][1][k] = 0.25f * wo;
      } else if (hn == 1) {
        o[0][0][k] += 0.75f * we;
        o[0][1][k] += 0.75f * wo;
        o[1][0][k] = 0.75f * we;
        o[1][1][k] = 0.75f * wo;
      } else {
        o[1][0][k] += 0.25f * we;
        o[1][1][k] += 0.25f * wo;
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
    upsample2x_kernel(const T* __restrict__ x, T* __restrict__ y, int D, int H,
                      int W, int C, int pitch, int offset, int nth, int ntw) {
  constexpr int E = Piece<T>::N;      // channels of a piece
  __shared__ __align__(16) uint4 tile[HALO];
  int t = blockIdx.x;
  const int d0 = (t / (nth * ntw)) * TD;
  t %= nth * ntw;
  const int h0 = (t / ntw) * TH, w0 = (t % ntw) * TW;
  const int c0 = blockIdx.y * PIECES * E;
  const int n = blockIdx.z;
  const int np = min(PIECES, (C - c0) / E);  // pieces of this chunk
  const T* xn = x + (long long)n * D * H * W * C + c0;

  // the halo tile, at clamped addresses: the replicate edge
  const uint32_t sbase = (uint32_t)__cvta_generic_to_shared(tile);
  for (int i = threadIdx.x; i < HALO; i += THREADS) {
    const int p = i & (PIECES - 1);
    if (p >= np) continue;
    const int v = i / PIECES;
    const int a = v / (HH * HW), rem = v % (HH * HW);
    const int b = rem / HW, c = rem % HW;
    const int dd = min(max(d0 - 1 + a, 0), D - 1);
    const int hh = min(max(h0 - 1 + b, 0), H - 1);
    const int ww = min(max(w0 - 1 + c, 0), W - 1);
    cp_async16(sbase + i * 16, xn + ((long long)(dd * H + hh) * W + ww) * C + p * E);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const int p = threadIdx.x % PIECES;
  const int lw = (threadIdx.x / PIECES) % TW;
  const int lh = threadIdx.x / (PIECES * TW);
  const int h = h0 + lh, w = w0 + lw;
  if (p >= np || h >= H || w >= W) return;
  const int dn = min(TD, D - d0);  // tile voxels along d inside the volume
  const long long Ho = 2LL * H, Wo = 2LL * W;
  // output voxel (n, od, 2h + b, 2w + e), channels offset + c0 + E p
  T* yb = y + (((long long)n * 2 * D * Ho + 2LL * h) * Wo + 2LL * w) * pitch +
          offset + c0 + p * E;
  auto emit = [&](int od, const float (&lo)[2][2][E], const float (&hi)[2][2][E],
                  float wlo, float whi) {
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float o[E];
#pragma unroll
        for (int k = 0; k < E; ++k) o[k] = wlo * lo[b][e][k] + whi * hi[b][e][k];
        *reinterpret_cast<uint4*>(yb + ((od * Ho + b) * Wo + e) * pitch) =
            Piece<T>::pack(o);
      }
  };

  float prev[2][2][E], cur[2][2][E];
  row_hw<T>(tile, 0, lh, lw, p, prev);
  for (int r = 1; r <= dn + 1; ++r) {
    row_hw<T>(tile, r, lh, lw, p, cur);
    // halo row r is input d0 - 1 + r: it completes the odd phase of voxel
    // d0 + r - 2 and the even phase of voxel d0 + r - 1
    if (r >= 2) emit(2 * (d0 + r - 2) + 1, prev, cur, 0.75f, 0.25f);
    if (r <= dn) emit(2 * (d0 + r - 1), prev, cur, 0.25f, 0.75f);
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int k = 0; k < E; ++k) prev[b][e][k] = cur[b][e][k];
  }
}

// ---------------------------------------------------------------- down --
//
// Replaces: brats2019_tpu/ops/pallas_resize.py downsample2x_pallas (:268,
// kernel _down_fwd_kernel :254): the 2^3 average, y[n, i, j, k] = 1/8 of the
// sum of x[n, 2i + a, 2j + b, 2k + e] over a, b, e in {0, 1}; an odd extent's
// last plane is dropped (the output extent is D / 2, rounded down).
//
// What bounds it on the card: device-memory bytes (x read once, y an eighth
// of that written; one add per input value). What held the Triton kernel
// (ops/triton_resize.py _down2x_kernel) at f32 with few channels was its
// grid: one program of 1024 lanes per output (n, d, h) row, of which a row of
// Wo C = 128 values (the accuracy config's C = 8) used an eighth, and the
// runtime C in its address math, which kept its loads to scalar 4 bytes. The
// design:
//
//   * One thread per 16-byte output piece (4 f32 channels) over a flat
//     (n, do, ho, wo, piece) index, so no lane idles but in the last block.
//   * Its 8 input pieces are loaded before any add (16-byte loads through
//     the non-coherent path, so the two w voxels of a window, 2 x 16 C bytes
//     apart, share L1 lines with the warp's neighbours: at C = 8 a warp's
//     loads of one (a, b) row cover 1 KB contiguous).
//   * The sum in one fixed order (a, then b, then e, from 0), times 0.125;
//     one 16-byte store. Bitwise repeatable.
//   * Templated over the piece type like the up; only the f32 instance is
//     exported (the bf16 down stays on Triton, which a full row fills).

constexpr int DOWN_THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(DOWN_THREADS)
    downsample2x_kernel(const uint4* __restrict__ x, uint4* __restrict__ y,
                        int D, int H, int W, int P, int Do, int Ho, int Wo,
                        int total) {
  constexpr int E = Piece<T>::N;
  const int i = blockIdx.x * DOWN_THREADS + threadIdx.x;
  if (i >= total) return;
  int v = i / P;
  const int p = i - v * P;
  const int wo = v % Wo;
  v /= Wo;
  const int ho = v % Ho;
  v /= Ho;
  const int od = v % Do, n = v / Do;
  const long long sw = P, sh = (long long)W * P, sd = (long long)H * W * P;
  const uint4* src = x + ((long long)n * D + 2 * od) * sd + 2LL * ho * sh +
                     2LL * wo * sw + p;
  uint4 in[8];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        in[4 * a + 2 * b + e] = __ldg(src + a * sd + b * sh + e * sw);
  float acc[E];
#pragma unroll
  for (int k = 0; k < E; ++k) acc[k] = 0.f;
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    float f[E];
    Piece<T>::unpack(in[m], f);
#pragma unroll
    for (int k = 0; k < E; ++k) acc[k] += f[k];
  }
#pragma unroll
  for (int k = 0; k < E; ++k) acc[k] *= 0.125f;
  y[i] = Piece<T>::pack(acc);
}

// ------------------------------------------------------------- backward --
//
// Replaces: brats2019_tpu/ops/pallas_resize.py _upsample2x_bwd_impl (:213,
// kernel _up_bwd_kernel :188). The exact transpose of the forward: per axis
// dx[j] = 0.25 g[2j-1] + 0.75 g[2j] + 0.75 g[2j+1] + 0.25 g[2j+2], fine
// indices clamped to the axis (so at an edge the clamped tap folds into the
// edge voxel's weight: the replicate clamp transposed).
//
// What bounds it on the card: device-memory bytes; g (8 values per dx value)
// is 8/9 of the traffic. What held the Triton kernel (ops/triton_resize.py
// _up2x_bwd_kernel) was 64 clamped scalar gathers per dx element, and the
// decoder's backward first copied the concat gradient's up half to a
// contiguous tensor. The design:
//
//   * A block owns BTH x BTW dx voxels in (h, w), a run of `td` dx voxels
//     along d (chosen by ops/resize.py plan_up_bwd: 8, 4, 2 or 1, whichever
//     makes the busiest SM walk the fewest fine rows at two blocks per SM),
//     and a chunk of PC 16-byte pieces of channels. PC is the instance: 8
//     (64 bf16 or 32 f32 channels) or 4 (16 f32 channels); BTW = 64 / PC, so
//     both instances have 256 threads and a ring row of ~22 KB, and a block
//     of few channels widens in w instead of idling (f32 C = 16 is 4 pieces:
//     BTW = 16). bf16 has the one instance PC = 8.
//   * It walks the 2 td + 2 fine d-rows its run reads. Each fine row's
//     (2 BTH + 2) x (2 BTW + 2) patch comes into a 4-row ring in shared
//     memory by 16-byte cp.async at CLAMPED addresses, read straight from g
//     with a channel pitch: g may be the up half of the decoder's (up, skip)
//     concat gradient, pitch Cu + Cskip, with no copy. Three rows stay in
//     flight while one is used.
//   * Thread (h, w, piece) reduces each fine row separably from shared
//     memory: 4 taps along w for each of its 4 fine h rows, then 4 along h;
//     the d taps are folded in registers as the rows pass (each fine row
//     feeds two dx rows), all in f32 in one fixed order; one 16-byte store
//     per output (8 bf16 channels rounded, or 4 f32 channels as computed).
//   * At PC = 4 a quarter-warp's 16-byte reads of one tap are 2 fine voxels
//     2 apart, which a plain layout puts on the same banks; its ring row
//     swaps the two voxels of each pair (a 128-byte bank row) where bit 1 of
//     the w index is set, so those reads are conflict-free. PC = 8 keeps the
//     plain layout.

// Probe builds for tools/torch_resize_check.py: RESIZE2X_UP_BWD_PROBE bit 0
// leaves out the fills, bit 1 the reduction and the stores (dx is not
// written).
#ifndef RESIZE2X_UP_BWD_PROBE
#define RESIZE2X_UP_BWD_PROBE 0
#endif

constexpr int BTH = 4;                                 // dx voxels of a tile in h
constexpr int FH = 2 * BTH + 2;                        // fine rows of its patch
constexpr int RING = 4;                                // fine rows in shared memory
constexpr int BTHREADS = 256;                          // threads of every instance

template <int PC>
struct UpBwdTile {
  static_assert(PC == 8 || PC == 4, "the instances");
  static constexpr int BTW = 64 / PC;                  // dx voxels of a tile in w
  static constexpr int FW = 2 * BTW + 2;               // fine columns of its patch
  static constexpr int ROW_SLOTS = FH * FW * PC;       // 16-byte slots of a row
  static constexpr int SMEM = RING * ROW_SLOTS * 16;
  static_assert(BTH * BTW * PC == BTHREADS, "one thread per (h, w, piece)");
  // the slot of piece p of fine voxel (a, b) of a ring row
  static __device__ __forceinline__ int slot(int a, int b, int p) {
    return (a * FW + (PC == 8 ? b : b ^ ((b >> 1) & 1))) * PC + p;
  }
};
static_assert(UpBwdTile<8>::SMEM == 92160, "the bf16 instance's ring");

template <typename T, int PC>
__global__ void __launch_bounds__(BTHREADS, 2)
    upsample2x_bwd_kernel(const T* __restrict__ g, T* __restrict__ dx, int D,
                          int H, int W, int C, int pitch, int td, int nth,
                          int ntw) {
  using Tile = UpBwdTile<PC>;
  constexpr int E = Piece<T>::N;       // channels of a piece
  constexpr int LOG_E = E == 8 ? 3 : 2;
  constexpr int BTW = Tile::BTW;
  extern __shared__ __align__(16) uint4 ring[];
  int t = blockIdx.x;
  const int d0 = (t / (nth * ntw)) * td;
  t %= nth * ntw;
  const int h0 = (t / ntw) * BTH, w0 = (t % ntw) * BTW;
  const int c0 = blockIdx.y * PC * E;
  const int n = blockIdx.z;
  const int np = min(PC, (C - c0) >> LOG_E);
  const int dn = min(td, D - d0);
  const int rows = 2 * dn + 2;  // fine rows 2 d0 - 1 .. 2 (d0 + dn)
  const long long Do = 2LL * D, Ho = 2LL * H, Wo = 2LL * W;
  const T* gn = g + (long long)n * Do * Ho * Wo * pitch + c0;
  const uint32_t sbase = (uint32_t)__cvta_generic_to_shared(ring);

  // f32 (COLUMNS): thread j < FW PC owns column (b, piece) of the patch;
  // its clamped fine w, channel offset and slot are fixed for the block, and
  // it copies that column of each of the FH fine h rows. bf16 keeps its
  // first loader, a flat loop over the row's slots (index math every copy).
  constexpr bool COLUMNS = sizeof(T) == 4;
  const int cb = threadIdx.x / PC, cp = threadIdx.x & (PC - 1);
  const bool loads = threadIdx.x < Tile::FW * PC && cp < np;
  const long long csrc =
      (long long)min(max(2 * w0 - 1 + cb, 0), (int)Wo - 1) * pitch + cp * E;
  const int cslot = loads ? Tile::slot(0, cb, cp) : 0;
  auto load_row = [&](int k) {
#if RESIZE2X_UP_BWD_PROBE & 1
    return;   // probe: no fills
#endif
    const long long fd = min(max(2 * d0 - 1 + k, 0), (int)Do - 1);
    const uint32_t row = sbase + (uint32_t)((k % RING) * Tile::ROW_SLOTS) * 16;
    if (COLUMNS) {
      if (!loads) return;
      const T* src = gn + fd * Ho * Wo * pitch + csrc;
#pragma unroll
      for (int a = 0; a < FH; ++a) {
        const long long fh = min(max(2 * h0 - 1 + a, 0), (int)Ho - 1);
        cp_async16(row + (a * Tile::FW * PC + cslot) * 16, src + fh * Wo * pitch);
      }
      return;
    }
    for (int i = threadIdx.x; i < FH * Tile::FW * PC; i += BTHREADS) {
      const int p = i & (PC - 1);
      if (p >= np) continue;
      const int v = i / PC, a = v / Tile::FW, b = v % Tile::FW;
      const long long fh = min(max(2 * h0 - 1 + a, 0), (int)Ho - 1);
      const long long fw = min(max(2 * w0 - 1 + b, 0), (int)Wo - 1);
      cp_async16(row + i * 16,  // PC = 8: slot(a, b, p) is i
                 gn + ((fd * Ho + fh) * Wo + fw) * pitch + p * E);
    }
  };
  auto commit = [] { asm volatile("cp.async.commit_group;\n" ::: "memory"); };

  const int p = threadIdx.x % PC;
  const int lw = (threadIdx.x / PC) % BTW;
  const int lh = threadIdx.x / (PC * BTW);
  const int h = h0 + lh, w = w0 + lw;
#if RESIZE2X_UP_BWD_PROBE & 2
  const bool active = false;   // probe: no reduction, no stores
#else
  const bool active = p < np && h < H && w < W;
#endif
  T* out = dx + (((long long)n * D + d0) * H + h) * W * C + (long long)w * C +
           c0 + p * E;
  const long long drow = (long long)H * W * C;  // one dx d-row

  // row sums of the d taps: (inner, outer) of row l - 1 (a) and row l (b)
  float in_a[E], out_a[E], in_b[E], out_b[E];
#pragma unroll
  for (int k = 0; k < E; ++k) in_a[k] = out_a[k] = in_b[k] = out_b[k] = 0.f;

  for (int k = 0; k < RING - 1; ++k) {
    if (k < rows) load_row(k);
    commit();
  }
  for (int k = 0; k < rows; ++k) {
    if (k + RING - 1 < rows) load_row(k + RING - 1);
    commit();
    asm volatile("cp.async.wait_group %0;\n" ::"n"(RING - 1) : "memory");
    __syncthreads();
    if (active) {
      // this fine row reduced over its 4 x 4 (h, w) taps, each axis as
      // 0.75 (tap 1 + tap 2) + 0.25 (tap 0 + tap 3)
      const uint4* s = ring + (k % RING) * Tile::ROW_SLOTS + p;
      float hi[E], ho[E], tk[E];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        float wi[E], wo[E], v[E];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          Piece<T>::unpack(s[Tile::slot(2 * lh + b, 2 * lw + e, 0)], v);
#pragma unroll
          for (int c = 0; c < E; ++c) {
            if (e == 0) wo[c] = v[c];
            else if (e == 1) wi[c] = v[c];
            else if (e == 2) wi[c] += v[c];
            else wo[c] += v[c];
          }
        }
#pragma unroll
        for (int c = 0; c < E; ++c) {
          const float r = 0.75f * wi[c] + 0.25f * wo[c];
          if (b == 0) ho[c] = r;
          else if (b == 1) hi[c] = r;
          else if (b == 2) hi[c] += r;
          else ho[c] += r;
        }
      }
#pragma unroll
      for (int c = 0; c < E; ++c) tk[c] = 0.75f * hi[c] + 0.25f * ho[c];
      if ((k & 1) == 0) {
        // fine row k is the second inner tap of row l - 1 and the first
        // outer tap of row l = k / 2
#pragma unroll
        for (int c = 0; c < E; ++c) {
          in_a[c] = in_b[c] + tk[c];
          out_a[c] = out_b[c];
          out_b[c] = tk[c];
        }
      } else {
        // the first inner tap of row l = (k - 1) / 2, the last outer tap of
        // row l - 1, which is then complete
#pragma unroll
        for (int c = 0; c < E; ++c) {
          in_b[c] = tk[c];
          out_a[c] += tk[c];
        }
        const int l = (k - 1) / 2 - 1;
        if (l >= 0) {
          float o[E];
#pragma unroll
          for (int c = 0; c < E; ++c) o[c] = 0.75f * in_a[c] + 0.25f * out_a[c];
          *reinterpret_cast<uint4*>(out + l * drow) = Piece<T>::pack(o);
        }
      }
    }
    __syncthreads();  // the slot is refilled three rows on
  }
}

// --------------------------------------------------------- down backward --
//
// Replaces: brats2019_tpu/ops/pallas_resize.py _downsample2x_bwd_impl (:304,
// kernel _down_bwd_kernel :292): dx[n, d, h, w] = g[n, d/2, h/2, w/2] / 8,
// and 0 on a plane past 2 Do, 2 Ho or 2 Wo (an odd extent's last plane,
// dropped by the forward).
//
// What bounds it on the card: device-memory bytes, and those are the stores
// (dx is 8x g; no arithmetic but one exact multiply by 2^-3). What held the
// Triton kernel (ops/triton_resize.py _down2x_bwd_kernel) at f32 with few
// channels was its grid, one program of 1024 lanes per dx (n, d, h) row of
// which a row of W C = 512 values used half, and the runtime C in its
// address math, which kept its loads and stores to scalar 4 bytes. The
// design: one thread per g piece (a 2^3 window, over ceil(D/2) x ceil(H/2) x
// ceil(W/2) windows so that the odd faces are zero-filled by the same
// launch): one load, 8 stores, each warp-wide store half of a span that the
// window's other w phase completes. (One thread per dx piece, the mirror of
// the down's forward, was timed against it and was no faster: PERF.md.)
//
// A block has 256 threads, or fewer (down to 32) where that leaves fewer than
// two blocks per SM: a small dx is then written from more SMs.
//
// g x 0.125 is exact in f32 (no -ftz, no fast math), so this is bitwise the
// plain version.

template <typename T>
__global__ void __launch_bounds__(DOWN_THREADS)
    downsample2x_bwd_kernel(const uint4* __restrict__ g, uint4* __restrict__ dx,
                            int D, int H, int W, int P, int Do, int Ho, int Wo,
                            int total) {
  constexpr int E = Piece<T>::N;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  int v = i / P;
  const int p = i - v * P;
  const int Wc = (W + 1) / 2, Hc = (H + 1) / 2, Dc = (D + 1) / 2;
  const int k = v % Wc;
  v /= Wc;
  const int j = v % Hc;
  v /= Hc;
  const int a0 = v % Dc, n = v / Dc;
  uint4 o = make_uint4(0u, 0u, 0u, 0u);
  if (a0 < Do && j < Ho && k < Wo) {
    float f[E];
    Piece<T>::unpack(
        __ldg(g + ((((long long)n * Do + a0) * Ho + j) * Wo + k) * P + p), f);
#pragma unroll
    for (int e = 0; e < E; ++e) f[e] *= 0.125f;
    o = Piece<T>::pack(f);
  }
  const long long sw = P, sh = (long long)W * P, sd = (long long)H * W * P;
  uint4* dst = dx + ((long long)n * D + 2 * a0) * sd + 2LL * j * sh +
               2LL * k * sw + p;
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (2 * a0 + a < D && 2 * j + b < H && 2 * k + e < W)
          dst[a * sd + b * sh + e * sw] = o;
}

}  // namespace

namespace {

template <typename T>
int up_run(const void* x, void* y, int N, int D, int H, int W, int C, int pitch,
           int offset, void* stream) {
  constexpr int E = Piece<T>::N;
  if (N < 1 || D < 1 || H < 1 || W < 1 || C < E || C % E || pitch % E ||
      offset % E || offset < 0 || offset + C > pitch || N > 65535 ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) % 16)
    return (int)cudaErrorInvalidValue;
  const int ntd = (D + TD - 1) / TD, nth = (H + TH - 1) / TH,
            ntw = (W + TW - 1) / TW;
  const long long tiles = (long long)ntd * nth * ntw;
  const int chunks = (C + PIECES * E - 1) / (PIECES * E);
  if (tiles > 0x7FFFFFFFLL || chunks > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)tiles, (unsigned)chunks, (unsigned)N);
  upsample2x_kernel<T><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<T*>(y), D, H, W, C, pitch, offset,
      nth, ntw);
  return (int)cudaGetLastError();
}

template <typename T, int PC>
int up_bwd_run(const void* g, void* dx, int N, int D, int H, int W, int C,
               int pitch, int td, void* stream) {
  using Tile = UpBwdTile<PC>;
  constexpr int E = Piece<T>::N;
  // the shared-memory attribute, once per device and instance
  constexpr int MAX_DEVICES = 64;
  static bool ready[MAX_DEVICES] = {false};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= MAX_DEVICES)
    return (int)cudaErrorInvalidDevice;
  if (!ready[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        upsample2x_bwd_kernel<T, PC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Tile::SMEM);
    if (err != cudaSuccess) return (int)err;
    ready[dev] = true;
  }
  const int nth = (H + BTH - 1) / BTH, ntw = (W + Tile::BTW - 1) / Tile::BTW;
  const int chunks = (C + PC * E - 1) / (PC * E);
  const long long tiles = (long long)((D + td - 1) / td) * nth * ntw;
  if (tiles > 0x7FFFFFFFLL || chunks > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)tiles, (unsigned)chunks, (unsigned)N);
  upsample2x_bwd_kernel<T, PC><<<grid, BTHREADS, Tile::SMEM,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(g), static_cast<T*>(dx), D, H, W, C, pitch, td, nth,
      ntw);
  return (int)cudaGetLastError();
}

bool up_bwd_args_ok(const void* g, void* dx, int N, int D, int H, int W, int C,
                    int pitch, int td, int E) {
  return N >= 1 && D >= 1 && H >= 1 && W >= 1 && C >= E && C % E == 0 &&
         pitch % E == 0 && pitch >= C && N <= 65535 && td >= 1 &&
         (reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(dx)) % 16 == 0;
}

}  // namespace

// x (N, D, H, W, C) contiguous bf16; y: (N, 2D, 2H, 2W, pitch) bf16, of which
// channels [offset, offset + C) are written (pitch = C, offset 0 for a plain
// output; the up half of a concat buffer otherwise). C, pitch and offset
// multiples of 8, both pointers 16-byte aligned. Launches on `stream`;
// returns cudaGetLastError() (cudaErrorInvalidValue for arguments it does not
// take).
extern "C" int upsample2x_ndhwc_bf16(const void* x, void* y, int N, int D,
                                     int H, int W, int C, int pitch, int offset,
                                     void* stream) {
  return up_run<__nv_bfloat16>(x, y, N, D, H, W, C, pitch, offset, stream);
}

// The same in f32: x, y f32; C, pitch and offset multiples of 4. The values
// are stored as computed (f32, no rounding step).
extern "C" int upsample2x_ndhwc_f32(const void* x, void* y, int N, int D,
                                    int H, int W, int C, int pitch, int offset,
                                    void* stream) {
  return up_run<float>(x, y, N, D, H, W, C, pitch, offset, stream);
}

// x (N, D, H, W, C) contiguous f32, D, H, W >= 2, C % 4 == 0; y (N, D / 2,
// H / 2, W / 2, C) contiguous f32 (extents rounded down); both pointers
// 16-byte aligned. Launches on `stream`; returns cudaGetLastError()
// (cudaErrorInvalidValue for arguments it does not take).
extern "C" int downsample2x_ndhwc_f32(const void* x, void* y, int N, int D,
                                      int H, int W, int C, void* stream) {
  constexpr int E = Piece<float>::N;
  if (N < 1 || D < 2 || H < 2 || W < 2 || C < E || C % E ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) % 16)
    return (int)cudaErrorInvalidValue;
  const int P = C / E, Do = D / 2, Ho = H / 2, Wo = W / 2;
  const long long total = (long long)N * Do * Ho * Wo * P;
  if (total > 0x7FFFFFFFLL - DOWN_THREADS) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((total + DOWN_THREADS - 1) / DOWN_THREADS);
  downsample2x_kernel<float><<<blocks, DOWN_THREADS, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(y), D, H, W, P, Do, Ho,
      Wo, (int)total);
  return (int)cudaGetLastError();
}

// g: (N, 2D, 2H, 2W) voxels of C channels at a channel pitch of `pitch`
// elements (pitch = C for a contiguous g; Cu + Cskip for the up half of a
// concat gradient, g pointing at its first channel); dx: (N, D, H, W, C)
// contiguous. C and pitch multiples of 8, both pointers 16-byte aligned; td
// >= 1, the dx voxels of a block's run along d (ops/resize.py plan_up_bwd).
// Launches on `stream`; returns cudaGetLastError() (cudaErrorInvalidValue
// for arguments it does not take).
extern "C" int upsample2x_bwd_ndhwc_bf16(const void* g, void* dx, int N, int D,
                                         int H, int W, int C, int pitch, int td,
                                         void* stream) {
  if (!up_bwd_args_ok(g, dx, N, D, H, W, C, pitch, td, Piece<__nv_bfloat16>::N))
    return (int)cudaErrorInvalidValue;
  return up_bwd_run<__nv_bfloat16, 8>(g, dx, N, D, H, W, C, pitch, td, stream);
}

// The same in f32: g, dx f32; C and pitch multiples of 4. `pieces` (8 or 4)
// is the instance, the 16-byte pieces of a block's channel chunk, chosen with
// td by ops/resize.py plan_up_bwd. The values are stored as computed.
extern "C" int upsample2x_bwd_ndhwc_f32(const void* g, void* dx, int N, int D,
                                        int H, int W, int C, int pitch,
                                        int pieces, int td, void* stream) {
  if (!up_bwd_args_ok(g, dx, N, D, H, W, C, pitch, td, Piece<float>::N))
    return (int)cudaErrorInvalidValue;
  switch (pieces) {
    case 8: return up_bwd_run<float, 8>(g, dx, N, D, H, W, C, pitch, td, stream);
    case 4: return up_bwd_run<float, 4>(g, dx, N, D, H, W, C, pitch, td, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The up backward's dynamic shared memory at `pieces` pieces a chunk, for
// ops/resize.py plan_up_bwd to be held to on the card; -1 for an instance
// the file does not have.
extern "C" int upsample2x_bwd_smem_bytes(int pieces) {
  switch (pieces) {
    case 8: return UpBwdTile<8>::SMEM;
    case 4: return UpBwdTile<4>::SMEM;
    default: return -1;
  }
}

// g (N, D / 2, H / 2, W / 2, C) contiguous f32 (extents rounded down), dx
// (N, D, H, W, C) contiguous f32, D, H, W >= 1, C % 4 == 0; both pointers
// 16-byte aligned. dx = g / 8 on each voxel of its 2^3 window, 0 on a plane
// past 2 (D / 2) (and likewise H, W). Launches on `stream`; returns
// cudaGetLastError() (cudaErrorInvalidValue for arguments it does not take).
extern "C" int downsample2x_bwd_ndhwc_f32(const void* g, void* dx, int N, int D,
                                          int H, int W, int C, void* stream) {
  constexpr int E = Piece<float>::N;
  if (N < 1 || D < 1 || H < 1 || W < 1 || C < E || C % E ||
      (reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(dx)) % 16)
    return (int)cudaErrorInvalidValue;
  constexpr int MAX_DEVICES = 64;
  static int sms[MAX_DEVICES] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= MAX_DEVICES)
    return (int)cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    cudaError_t err =
        cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  const int P = C / E;
  const long long total =
      (long long)N * ((D + 1) / 2) * ((H + 1) / 2) * ((W + 1) / 2) * P;
  if (total > 0x7FFFFFFFLL - DOWN_THREADS) return (int)cudaErrorInvalidValue;
  int threads = DOWN_THREADS;
  while (threads > 32 && (total + threads - 1) / threads < 2LL * sms[dev]) threads /= 2;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  downsample2x_bwd_kernel<float><<<blocks, threads, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(g), static_cast<uint4*>(dx), D, H, W, P, D / 2,
      H / 2, W / 2, (int)total);
  return (int)cudaGetLastError();
}
