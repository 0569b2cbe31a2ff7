// Shifted-window 3D self-attention of the Swin UNETR, bf16, head dim 16, on
// Hopper. Built by brats2019_tpu_torch/ops/_build.py with nvcc -gencode
// arch=compute_90a,code=sm_90a; called through ctypes from
// brats2019_tpu_torch/ops/window_attention.py (window_attention_kernel, the
// CUDA implementation of brats_torch::window_attention).
//
// Replaces: no Pallas kernel (the JAX package has no attention). The
// function, per window w and head h of a (windows, T, 3C) qkv (channels
// ordered q | k | v, head, head dim):
//
//   out[w, i, h] = softmax_j(q_i k_j^T * scale + B[rel(i, j), h] + M(i, j)) v_j
//
// with B the (2 wc - 1)^3 x heads relative-position table and M the shift
// mask (0, or -100 where query and key lie in different regions of the
// rolled, padded grid along some axis); ops/window_attention.py states both.
//
// Design. A block of 4 warps per (window, head):
//
//   * the window's keys and values of the head (T <= 352 rows of 16 bf16)
//     go to shared memory once, K row-major with rows padded to 24 values
//     and V transposed (16 rows of the window's tokens, padded to 360), so
//     that every fragment a warp reads from them is one 32-bit word a lane
//     without a bank conflict; the head's column of B, already times log2 e
//     (a contiguous row of the transposed table the wrapper hands over),
//     goes there too, and per key one word: its offset code inside the
//     window (d (2 wc - 1)^2 + h (2 wc - 1) + w) and its region code (the
//     three regions per axis of the rolled grid, as 9 rd + 3 rh + rw), or -1
//     for a key past T;
//   * rel(i, j) is the query's offset code less the key's plus
//     (wc - 1) ((2 wc - 1)^2 + (2 wc - 1) + 1), so B is one shared-memory
//     read a score; M is a compare of two region codes (all codes are 0 in
//     a window that no shifted axis cuts);
//   * each warp takes tiles of 16 queries (T = 343: 22 tiles), its q read
//     from global memory straight into the A fragment of mma.sync
//     m16n8k16 (bf16 operands, f32 accumulation; head dim 16 is one k-step);
//     it walks the keys in blocks of 32: S = q K^T for 4 n-tiles of 8 keys,
//     x = S scale log2 e + B + M (log2 domain), an online softmax (running
//     max and sum per row, reduced over the 4 lanes that share a row), p =
//     2^(x - max) by ex2.approx, and O += p V by 2 more k-steps of mma.sync,
//     p's accumulator fragments reused as A fragments in bf16;
//   * the output row divided by its sum, stored as bf16 pairs at the
//     window's row and the head's 16 channels.
//
// Nothing but q, k, v, the table column and the output moves through device
// memory; no score, B or M is materialised. Keys past T read -inf; queries
// past T are computed on zeros and not stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int HD = 16;          // head dim: one k-step of m16n8k16
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int MAX_T = 352;      // tokens a window (343) padded to the key blocks
constexpr int KEY_BLOCK = 32;   // keys of one online-softmax step
constexpr int KS = 24;          // K's row pitch in shared memory (bf16)
constexpr int VS = MAX_T + 8;   // V^T's row pitch in shared memory (bf16)
constexpr int MAX_TABLE = 2197; // (2 * 7 - 1)^3
constexpr float MASK_LOG2 = -100.0f * 1.4426950408889634f;   // M, log2 domain

struct Geometry {
  int T, wd, wh, ww;        // tokens and window extents
  int nwh, nww, per_sample; // windows along h and w; windows a sample
  int pd, ph, pw;           // the padded grid
  int sd, sh, sw;           // the shift along each axis
  int wc, heads;            // the table's window and heads
  float scale_log2;         // scale * log2 e
};

__device__ __forceinline__ int region(int pos, int P, int W, int S) {
  return (pos >= P - W) + (S > 0 && pos >= P - S);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d = a b + d, m16n8k16, bf16 operands, f32 accumulator
__device__ __forceinline__ void mma(float* d, const uint32_t* a, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(THREADS)
window_attention_kernel(const __nv_bfloat16* __restrict__ qkv,
                        const float* __restrict__ table,
                        __nv_bfloat16* __restrict__ out, Geometry g) {
  __shared__ __align__(16) __nv_bfloat16 sK[MAX_T * KS];
  __shared__ __align__(16) __nv_bfloat16 sVt[HD * VS];
  __shared__ int sKey[MAX_T];
  __shared__ float sTab[MAX_TABLE];

  const int win = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const int T = g.T, C = g.heads * HD, row = 3 * C;
  const int R = 2 * g.wc - 1, R3 = R * R * R;
  const int blocks = (T + KEY_BLOCK - 1) / KEY_BLOCK, KT = blocks * KEY_BLOCK;
  const __nv_bfloat16* base = qkv + (size_t)win * T * row + h * HD;

  // the window's origin in the padded grid, and whether a shifted axis cuts it
  const int w_in = win % g.per_sample;
  const int od = (w_in / (g.nwh * g.nww)) * g.wd;
  const int oh = ((w_in / g.nww) % g.nwh) * g.wh;
  const int ow = (w_in % g.nww) * g.ww;
  const bool masked = (g.sd > 0 && od == g.pd - g.wd) ||
                      (g.sh > 0 && oh == g.ph - g.wh) ||
                      (g.sw > 0 && ow == g.pw - g.ww);

  for (int i = tid; i < R3; i += THREADS) sTab[i] = table[h * R3 + i];
  for (int i = tid; i < 2 * KT; i += THREADS) {
    const int j = i >> 1, half = i & 1;
    uint4 k = make_uint4(0, 0, 0, 0), v = k;
    if (j < T) {
      const __nv_bfloat16* p = base + (size_t)j * row + half * 8;
      k = *reinterpret_cast<const uint4*>(p + C);
      v = *reinterpret_cast<const uint4*>(p + 2 * C);
    }
    *reinterpret_cast<uint4*>(&sK[j * KS + half * 8]) = k;
    const __nv_bfloat16* vv = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
    for (int c = 0; c < 8; ++c) sVt[(half * 8 + c) * VS + j] = vv[c];
  }
  for (int j = tid; j < KT; j += THREADS) {
    int code = -1;
    if (j < T) {
      const int kd = j / (g.wh * g.ww), kh = (j / g.ww) % g.wh, kw = j % g.ww;
      const int reg = masked ? region(od + kd, g.pd, g.wd, g.sd) * 9 +
                                   region(oh + kh, g.ph, g.wh, g.sh) * 3 +
                                   region(ow + kw, g.pw, g.ww, g.sw)
                             : 0;
      code = (kd * R + kh) * R + kw + (reg << 16);
    }
    sKey[j] = code;
  }
  __syncthreads();

  const int lane = tid & 31, gq = lane >> 2, t4 = lane & 3;
  const int off = (g.wc - 1) * (R * R + R + 1);
  const int qtiles = (T + 15) / 16;
  for (int qt = tid >> 5; qt < qtiles; qt += WARPS) {
    int rows[2], cq[2], rq[2];
    uint32_t a[4];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rows[r] = qt * 16 + gq + 8 * r;
      const int i = min(rows[r], T - 1);   // a query past T: any valid offset
      const int qd = i / (g.wh * g.ww), qh = (i / g.ww) % g.wh, qw = i % g.ww;
      cq[r] = (qd * R + qh) * R + qw + off;
      rq[r] = masked ? region(od + qd, g.pd, g.wd, g.sd) * 9 +
                           region(oh + qh, g.ph, g.wh, g.sh) * 3 +
                           region(ow + qw, g.pw, g.ww, g.sw)
                     : 0;
      const uint32_t* q =
          reinterpret_cast<const uint32_t*>(base + (size_t)i * row);
      const bool ok = rows[r] < T;
      a[r] = ok ? q[t4] : 0u;          // cols 2 t4, 2 t4 + 1
      a[r + 2] = ok ? q[t4 + 4] : 0u;  // cols 8 + 2 t4, 9 + 2 t4
    }
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    float o[2][4] = {};
    for (int kb = 0; kb < blocks; ++kb) {
      float s[4][4] = {};
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const __nv_bfloat16* kr = &sK[(kb * KEY_BLOCK + nt * 8 + gq) * KS + 2 * t4];
        mma(s[nt], a, *reinterpret_cast<const uint32_t*>(kr),
            *reinterpret_cast<const uint32_t*>(kr + 8));
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int code = sKey[kb * KEY_BLOCK + nt * 8 + 2 * t4 + e];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float x = -INFINITY;
            if (code >= 0) {
              x = s[nt][2 * r + e] * g.scale_log2 + sTab[cq[r] - (code & 0xFFFF)];
              if (rq[r] != (code >> 16)) x += MASK_LOG2;
            }
            s[nt][2 * r + e] = x;
            mx[r] = fmaxf(mx[r], x);
          }
        }
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float mn = fmaxf(m[r], mx[r]);
        alpha[r] = ex2(m[r] - mn);
        m[r] = mn;
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float p = ex2(s[nt][c] - m[c >> 1]);
          s[nt][c] = p;
          l[c >> 1] += p;
        }
      }
#pragma unroll
      for (int on = 0; on < 2; ++on) {
#pragma unroll
        for (int c = 0; c < 4; ++c) o[on][c] *= alpha[c >> 1];
      }
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        const uint32_t pa[4] = {pack_bf16(s[2 * ks][0], s[2 * ks][1]),
                                pack_bf16(s[2 * ks][2], s[2 * ks][3]),
                                pack_bf16(s[2 * ks + 1][0], s[2 * ks + 1][1]),
                                pack_bf16(s[2 * ks + 1][2], s[2 * ks + 1][3])};
        const int key = kb * KEY_BLOCK + ks * 16 + 2 * t4;
#pragma unroll
        for (int on = 0; on < 2; ++on) {
          const __nv_bfloat16* vr = &sVt[(on * 8 + gq) * VS + key];
          mma(o[on], pa, *reinterpret_cast<const uint32_t*>(vr),
              *reinterpret_cast<const uint32_t*>(vr + 8));
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      if (rows[r] >= T) continue;
      const float inv = 1.0f / l[r];
      uint32_t* dst = reinterpret_cast<uint32_t*>(
          out + ((size_t)win * T + rows[r]) * C + h * HD + 2 * t4);
      dst[0] = pack_bf16(o[0][2 * r] * inv, o[0][2 * r + 1] * inv);
      dst[4] = pack_bf16(o[1][2 * r] * inv, o[1][2 * r + 1] * inv);
    }
  }
}

}  // namespace

// qkv (nw, T, 3 heads 16) and out (nw, T, heads 16) bf16, table (heads,
// (2 wc - 1)^3) f32 times log2 e, all contiguous and 16-byte aligned on the
// current device; T <= 352, wc <= 7. Launches on `stream`.
extern "C" int window_attention_bf16(const void* qkv, const void* table, void* out,
                                     int nw, int T, int wd, int wh, int ww,
                                     int pd, int ph, int pw, int sd, int sh,
                                     int sw, int wc, int heads, float scale_log2,
                                     void* stream) {
  Geometry g;
  g.T = T;
  g.wd = wd;
  g.wh = wh;
  g.ww = ww;
  g.nwh = ph / wh;
  g.nww = pw / ww;
  g.per_sample = (pd / wd) * g.nwh * g.nww;
  g.pd = pd;
  g.ph = ph;
  g.pw = pw;
  g.sd = sd;
  g.sh = sh;
  g.sw = sw;
  g.wc = wc;
  g.heads = heads;
  g.scale_log2 = scale_log2;
  if (nw > 0) {
    window_attention_kernel<<<dim3(nw, heads), THREADS, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const __nv_bfloat16*>(qkv), static_cast<const float*>(table),
        static_cast<__nv_bfloat16*>(out), g);
  }
  return static_cast<int>(cudaGetLastError());
}
