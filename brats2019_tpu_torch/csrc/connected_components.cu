// 26-connected component labelling of a (D, H, W) boolean mask by union-find
// over 2x2x2 blocks, on Hopper. Built by brats2019_tpu_torch/ops/_build.py
// with nvcc -gencode arch=compute_90a,code=sm_90a; called through ctypes from
// brats2019_tpu_torch/ops/connected_components.py (label_components_kernel,
// the CUDA implementation of brats_torch::label_components).
//
// Replaces: no Pallas kernel. The reference labels by plain propagation
// (brats2019_tpu/ops/connected_components.py label_components: a 26-neighbour
// lax.reduce_window max of the voxels' ids until nothing changes, then pool
// and pointer-jump rounds), and the port's plain form does the same with
// F.max_pool3d: O(diameter) passes over the whole canvas, 192 pooling passes
// and 2 jump rounds on the flagship's (192, 224, 160) canvas, each a read and
// a write of the ids, with a host read of a convergence flag every 8 passes.
//
// The result is the same converged labelling: every foreground voxel reads
// its component's largest linear voxel index + 1, background reads 0.
//
// What bounds it on the card: device-memory bytes. It has to read the mask
// once (1 byte a voxel) and write the ids once (4 bytes a voxel): 34.4 MB,
// 10 us at 3.35 TB/s on the whole canvas. What held a plain global
// union-find (every node uniting with its neighbours through global atomics)
// to 88 ms there on an H100 is the data: the cohort's masks are ~91%
// foreground, one to three components spanning the canvas, and every find
// walked chains of global parents that all the threads were lengthening at
// once. Uniting inside tiles first still left 6 ms in the unions across the
// tiles' faces, nearly all of them repeats of one pair of tile roots. The
// design:
//
//   * Under 26-connectivity the foreground voxels of a 2x2x2 block all touch
//     each other, so a block is one node of the union-find: 8x fewer nodes
//     than voxels (ragged blocks at odd extents hold fewer voxels). Its key is
//     the largest linear index of a foreground voxel in it, its occupancy an
//     8-bit mask (bit lz * 4 + ly * 2 + lx).
//   * Adjacency of two neighbouring blocks is separable by axis: across an
//     offset of +1 only our high slab and the neighbour's low slab touch, so
//     the test is two ANDs of occupancy masks. Each node looks at its 13
//     forward neighbours; the other 13 look at it from their side.
//   * A union links the root with the smaller key under the root with the
//     larger one by a compare-and-swap on the parent. Links only ever point to
//     larger keys, so there is no cycle, and each root's key ends as its
//     tree's largest, whatever order the atomics run in. Finds halve the path
//     as they go.
//   * local (a block of 512 threads a tile of 16 x 8 x 4 nodes, a thread a
//     node): reads the tile's mask once, unites inside the tile in shared
//     memory, then writes each node's parent as its tile-local root, its key
//     and its occupancy. A dense tile collapses to one root without a global
//     atomic.
//   * boundary (a block a tile, a thread a node): only the unions that cross
//     a tile's face, in global memory, and each as a union of the two nodes'
//     tile-local roots. A block unites each pair of roots once: a set of the
//     pairs it has seen, in shared memory, drops the repeats (a dense face
//     of 128 nodes, 9 offsets each, gives one pair). Parents are read through
//     L2 (ld.global.cg): the SMs' L1s are not coherent with the atomics.
//   * write (a thread a node): the node's root, and its 8 voxels' ids, root
//     key + 1 on foreground voxels and 0 on the others.
//
// Three launches, no host read, no allocation: the caller passes the node
// scratch (2 int32 and 1 byte a node, 7.7 MB on the whole canvas).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;                  // write
constexpr int TX = 16, TY = 8, TZ = 4;        // a tile's nodes, x fastest
constexpr int TILE = TX * TY * TZ;            // local and boundary: a thread a node
constexpr int SLOTS = 1024, PROBES = 32;      // boundary's set of pairs
constexpr unsigned long long EMPTY = ~0ull;

// occupancy bits of a block's voxels with local z, y or x = 0 or 1
constexpr unsigned Z0 = 0x0F, Z1 = 0xF0, Y0 = 0x33, Y1 = 0xCC, X0 = 0x55,
                   X1 = 0xAA;

struct Grid {
  int D, H, W;      // voxels
  int BD, BH, BW;   // blocks (nodes)
  int n;            // BD * BH * BW
};

// our voxels that can touch a neighbour block across an offset of o on one
// axis (the neighbour's are those of -o)
__device__ __forceinline__ unsigned slab(int o, unsigned lo, unsigned hi) {
  return o > 0 ? hi : (o < 0 ? lo : 0xFFu);
}

__device__ __forceinline__ bool touch(unsigned mine, unsigned theirs, int dz,
                                      int dy, int dx) {
  return (mine & slab(dz, Z0, Z1) & slab(dy, Y0, Y1) & slab(dx, X0, X1)) &&
         (theirs & slab(-dz, Z0, Z1) & slab(-dy, Y0, Y1) & slab(-dx, X0, X1));
}

// the k-th of the 13 forward offsets: dz = 1 (9), then dz = 0, dy = 1 (3),
// then dx = 1
__device__ __forceinline__ void offset(int k, int& dz, int& dy, int& dx) {
  if (k < 9) {
    dz = 1, dy = k / 3 - 1, dx = k % 3 - 1;
  } else if (k < 12) {
    dz = 0, dy = 1, dx = k - 10;
  } else {
    dz = 0, dy = 0, dx = 1;
  }
}

__device__ __forceinline__ void node_coords(const Grid& g, int n, int& bd,
                                            int& bh, int& bw) {
  bw = n % g.BW;
  const int t = n / g.BW;
  bh = t % g.BH;
  bd = t / g.BH;
}

// find and unite over parents in shared memory (volatile: other threads
// link and halve as this one walks)
__device__ __forceinline__ int find_local(volatile int* sp, int x) {
  for (;;) {
    const int p = sp[x];
    if (p == x) return x;
    const int gp = sp[p];
    if (gp == p) return p;
    sp[x] = gp;   // x stays a non-root: any ancestor is a valid parent
    x = gp;
  }
}

__device__ void unite_local(volatile int* sp, const int* sk, int a, int b) {
  for (;;) {
    a = find_local(sp, a);
    b = find_local(sp, b);
    if (a == b) return;
    if (sk[a] > sk[b]) {
      const int t = a;
      a = b;
      b = t;
    }
    // a (the smaller key) under b, if a is still a root
    if (atomicCAS(const_cast<int*>(sp + a), a, b) == a) return;
  }
}

// the same over parents in global memory, read through L2
__device__ __forceinline__ int find(int* P, int x) {
  for (;;) {
    const int p = __ldcg(P + x);
    if (p == x) return x;
    const int gp = __ldcg(P + p);
    if (gp == p) return p;
    P[x] = gp;
    x = gp;
  }
}

__device__ void unite(int* P, const int* K, int a, int b) {
  for (;;) {
    a = find(P, a);
    b = find(P, b);
    if (a == b) return;
    if (__ldg(K + a) > __ldg(K + b)) {
      const int t = a;
      a = b;
      b = t;
    }
    if (atomicCAS(P + a, a, b) == a) return;
  }
}

__global__ void __launch_bounds__(TILE)
    cc_local(const uint8_t* __restrict__ mask, int* __restrict__ P,
             int* __restrict__ K, uint8_t* __restrict__ B, Grid g, int tiles_x,
             int tiles_y) {
  __shared__ int sp[TILE];
  __shared__ int sk[TILE];
  __shared__ uint8_t sb[TILE];
  const int t = threadIdx.x;
  const int lx = t % TX, ly = (t / TX) % TY, lz = t / (TX * TY);
  const int tx = blockIdx.x % tiles_x, ty = (blockIdx.x / tiles_x) % tiles_y,
            tz = blockIdx.x / (tiles_x * tiles_y);
  const int bw = tx * TX + lx, bh = ty * TY + ly, bd = tz * TZ + lz;
  const bool inside = bw < g.BW && bh < g.BH && bd < g.BD;
  unsigned bits = 0;
  int key = -1;
  if (inside) {
#pragma unroll
    for (int vz = 0; vz < 2; ++vz) {
      const int d = 2 * bd + vz;
#pragma unroll
      for (int vy = 0; vy < 2; ++vy) {
        const int h = 2 * bh + vy;
#pragma unroll
        for (int vx = 0; vx < 2; ++vx) {
          const int w = 2 * bw + vx;
          if (d < g.D && h < g.H && w < g.W) {
            const int idx = (d * g.H + h) * g.W + w;
            if (__ldg(mask + idx)) {
              bits |= 1u << (vz * 4 + vy * 2 + vx);
              key = idx;   // the voxels come in increasing index
            }
          }
        }
      }
    }
  }
  sp[t] = t;
  sk[t] = key;
  sb[t] = (uint8_t)bits;
  __syncthreads();
  if (bits) {
#pragma unroll
    for (int k = 0; k < 13; ++k) {
      int dz, dy, dx;
      offset(k, dz, dy, dx);
      const int z = lz + dz, y = ly + dy, x = lx + dx;
      if (z >= TZ || y < 0 || y >= TY || x < 0 || x >= TX) continue;
      const int u = (z * TY + y) * TX + x;
      if (touch(bits, sb[u], dz, dy, dx)) unite_local(sp, sk, t, u);
    }
  }
  __syncthreads();
  if (!inside) return;
  const int r = find_local(sp, t);
  const int n = (bd * g.BH + bh) * g.BW + bw;
  P[n] = ((tz * TZ + r / (TX * TY)) * g.BH + ty * TY + (r / TX) % TY) * g.BW +
         tx * TX + r % TX;
  K[n] = key;
  B[n] = (uint8_t)bits;
}

// whether this block sees the pair of ancestors `key` for the first time: a
// probe of a shared-memory hash set; past PROBES full slots it answers yes
// (a union too many costs time, never a wrong label)
__device__ __forceinline__ bool first_time(unsigned long long* seen,
                                           unsigned long long key) {
  const unsigned h = (unsigned)((key * 0x9E3779B97F4A7C15ull) >> 54);
  for (int i = 0; i < PROBES; ++i) {
    const unsigned long long prev =
        atomicCAS(seen + ((h + i) & (SLOTS - 1)), EMPTY, key);
    if (prev == EMPTY) return true;
    if (prev == key) return false;
  }
  return true;
}

__global__ void __launch_bounds__(TILE)
    cc_boundary(int* P, const int* __restrict__ K,
                const uint8_t* __restrict__ B, Grid g, int tiles_x,
                int tiles_y) {
  __shared__ unsigned long long seen[SLOTS];
  for (int i = threadIdx.x; i < SLOTS; i += TILE) seen[i] = EMPTY;
  __syncthreads();
  const int t = threadIdx.x;
  const int lx = t % TX, ly = (t / TX) % TY, lz = t / (TX * TY);
  // inside the tile every forward neighbour is, and local did it
  if (lz < TZ - 1 && ly > 0 && ly < TY - 1 && lx > 0 && lx < TX - 1) return;
  const int tx = blockIdx.x % tiles_x, ty = (blockIdx.x / tiles_x) % tiles_y,
            tz = blockIdx.x / (tiles_x * tiles_y);
  const int bw = tx * TX + lx, bh = ty * TY + ly, bd = tz * TZ + lz;
  if (bw >= g.BW || bh >= g.BH || bd >= g.BD) return;
  const int n = (bd * g.BH + bh) * g.BW + bw;
  const unsigned mine = __ldg(B + n);
  if (!mine) return;
  // the node's tile-local root, or an ancestor of it: a union of ancestors
  // is the union of the nodes, and a dense tile's face holds one
  const int a = __ldcg(P + n);
#pragma unroll
  for (int k = 0; k < 13; ++k) {
    int dz, dy, dx;
    offset(k, dz, dy, dx);
    const int z = lz + dz, y = ly + dy, x = lx + dx;
    if (z < TZ && y >= 0 && y < TY && x >= 0 && x < TX) continue;
    const int zd = bd + dz, zh = bh + dy, zw = bw + dx;
    if (zd >= g.BD || zh < 0 || zh >= g.BH || zw < 0 || zw >= g.BW) continue;
    const int nb = (zd * g.BH + zh) * g.BW + zw;
    if (!touch(mine, __ldg(B + nb), dz, dy, dx)) continue;
    const int b = __ldcg(P + nb);
    if (a == b) continue;
    const unsigned long long key =
        a < b ? ((unsigned long long)a << 32) | (unsigned)b
              : ((unsigned long long)b << 32) | (unsigned)a;
    if (first_time(seen, key)) unite(P, K, a, b);
  }
}

__global__ void __launch_bounds__(THREADS)
    cc_write(int* P, const int* __restrict__ K, const uint8_t* __restrict__ B,
             int* __restrict__ out, Grid g) {
  const int n = blockIdx.x * THREADS + threadIdx.x;
  if (n >= g.n) return;
  const unsigned bits = __ldg(B + n);
  const int label = bits ? __ldg(K + find(P, n)) + 1 : 0;
  int bd, bh, bw;
  node_coords(g, n, bd, bh, bw);
#pragma unroll
  for (int vz = 0; vz < 2; ++vz) {
    const int d = 2 * bd + vz;
#pragma unroll
    for (int vy = 0; vy < 2; ++vy) {
      const int h = 2 * bh + vy;
#pragma unroll
      for (int vx = 0; vx < 2; ++vx) {
        const int w = 2 * bw + vx;
        if (d < g.D && h < g.H && w < g.W)
          out[(d * g.H + h) * g.W + w] =
              (bits >> (vz * 4 + vy * 2 + vx)) & 1u ? label : 0;
      }
    }
  }
}

}  // namespace

// mask (D, H, W) contiguous bytes (0 or not); out (D, H, W) contiguous int32;
// scratch 4-byte aligned, of n = ceil(D/2) ceil(H/2) ceil(W/2) nodes: n int32
// parents, n int32 keys, n bytes of occupancy; D, H, W >= 1 and D H W < 2^31.
// Launches three kernels on `stream`; returns cudaGetLastError()
// (cudaErrorInvalidValue for arguments it does not take).
extern "C" int label_components_3d(const void* mask, void* out, void* scratch,
                                   int D, int H, int W, void* stream) {
  if (D < 1 || H < 1 || W < 1 || (long long)D * H * W >= 0x7FFFFFFFLL ||
      reinterpret_cast<uintptr_t>(scratch) % 4 ||
      reinterpret_cast<uintptr_t>(out) % 4)
    return (int)cudaErrorInvalidValue;
  Grid g;
  g.D = D, g.H = H, g.W = W;
  g.BD = (D + 1) / 2, g.BH = (H + 1) / 2, g.BW = (W + 1) / 2;
  g.n = g.BD * g.BH * g.BW;
  int* P = static_cast<int*>(scratch);
  int* K = P + g.n;
  uint8_t* B = reinterpret_cast<uint8_t*>(K + g.n);
  const int tiles_x = (g.BW + TX - 1) / TX, tiles_y = (g.BH + TY - 1) / TY,
            tiles_z = (g.BD + TZ - 1) / TZ;
  const unsigned blocks = (unsigned)((g.n + THREADS - 1) / THREADS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cc_local<<<tiles_x * tiles_y * tiles_z, TILE, 0, s>>>(
      static_cast<const uint8_t*>(mask), P, K, B, g, tiles_x, tiles_y);
  cc_boundary<<<tiles_x * tiles_y * tiles_z, TILE, 0, s>>>(P, K, B, g, tiles_x,
                                                          tiles_y);
  cc_write<<<blocks, THREADS, 0, s>>>(P, K, B, static_cast<int*>(out), g);
  return (int)cudaGetLastError();
}
