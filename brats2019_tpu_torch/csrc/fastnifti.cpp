// fastnifti: native NIfTI-1 case loader for the host pipeline of the
// PyTorch port (a copy of the JAX package's root csrc/fastnifti.cpp; every
// line from the first #include on is the original's, which
// tests/test_torch_host.py checks).
//
// Per BraTS case, the host must gunzip + parse + reorder 4 modality volumes
// and compute per-modality nonzero statistics and the brain bounding box
// before anything reaches the card. zlib inflate is the dominant cost and is
// embarrassingly parallel across modalities; this library does, in one pass
// per volume:
//
//   gunzip -> header parse -> dtype decode (+scl scaling) ->
//   Fortran->C reorder fused with channel interleave (X,Y,Z,C out) ->
//   nonzero sum/sumsq/count + bbox accumulation
//
// threaded with std::thread across the files of a case. Python binds via
// ctypes (brats2019_tpu_torch/utils/nifti_fast.py), which builds this file
// with g++ at first use into build/host/ and falls back to the NumPy reader
// when the build or the load fails.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <exception>
#include <string>
#include <thread>
#include <vector>

#include <zlib.h>

namespace {

struct Header {
  int64_t nx = 0, ny = 0, nz = 0;
  int16_t datatype = 0;
  float scl_slope = 1.0f, scl_inter = 0.0f;
  int64_t vox_offset = 352;
  bool swapped = false;
};

template <typename T>
T bswap(T v) {
  union {
    T v;
    unsigned char b[sizeof(T)];
  } s, d;
  s.v = v;
  for (size_t i = 0; i < sizeof(T); ++i) d.b[i] = s.b[sizeof(T) - 1 - i];
  return d.v;
}

bool parse_header(const unsigned char* raw, size_t len, Header* h, char* err) {
  if (len < 352) {
    snprintf(err, 256, "file too short for NIfTI header");
    return false;
  }
  int32_t sizeof_hdr;
  memcpy(&sizeof_hdr, raw, 4);
  bool swapped = false;
  if (sizeof_hdr != 348) {
    if (bswap(sizeof_hdr) == 348) {
      swapped = true;
    } else {
      snprintf(err, 256, "not a NIfTI-1 file (sizeof_hdr=%d)", sizeof_hdr);
      return false;
    }
  }
  auto rd16 = [&](size_t off) {
    int16_t v;
    memcpy(&v, raw + off, 2);
    return swapped ? bswap(v) : v;
  };
  auto rdf = [&](size_t off) {
    float v;
    memcpy(&v, raw + off, 4);
    return swapped ? bswap(v) : v;
  };
  int16_t ndim = rd16(40);
  if (ndim < 3 || ndim > 7) {
    snprintf(err, 256, "bad ndim %d", ndim);
    return false;
  }
  h->nx = rd16(42);
  h->ny = rd16(44);
  h->nz = rd16(46);
  // A corrupt header with a non-positive extent would make n = nx*ny*nz
  // negative downstream; (size_t)n then wraps the truncation check and the
  // temp-buffer allocation throws past the C ABI (process abort). Reject
  // here, before any size arithmetic.
  if (h->nx <= 0 || h->ny <= 0 || h->nz <= 0) {
    snprintf(err, 256, "bad dims (%lld,%lld,%lld): extents must be positive",
             (long long)h->nx, (long long)h->ny, (long long)h->nz);
    return false;
  }
  for (int d = 4; d <= ndim; ++d) {
    if (rd16(40 + 2 * d) > 1) {
      snprintf(err, 256, "4D+ volumes unsupported in fast path");
      return false;
    }
  }
  h->datatype = rd16(70);
  h->scl_slope = rdf(112);
  h->scl_inter = rdf(116);
  float vox = rdf(108);
  if (std::isnan(vox) || vox <= 0.0f) {
    h->vox_offset = 352;  // unset -> spec default for .nii
  } else if (vox < 352.0f || vox > 1e12f) {
    snprintf(err, 256, "bad vox_offset %g", (double)vox);
    return false;
  } else {
    h->vox_offset = (int64_t)vox;
  }
  h->swapped = swapped;
  return true;
}

// read whole file, transparently gunzipping (gzread handles plain files too)
bool slurp(const char* path, std::vector<unsigned char>* out, char* err) {
  // Inflation cap: the largest legal NIfTI-1 volume this loader accepts is
  // 32767^3 voxels but a real BraTS case is ~110 MB decompressed; 4 GiB
  // bounds any legitimate single volume while turning a gzip bomb into a
  // clean error instead of an OOM abort of the serving process.
  constexpr size_t kMaxBytes = (size_t)4 << 30;
  gzFile f = gzopen(path, "rb");
  if (!f) {
    snprintf(err, 256, "cannot open %s", path);
    return false;
  }
  gzbuffer(f, 1 << 20);
  out->clear();
  out->reserve(16 << 20);
  unsigned char buf[1 << 20];
  int n;
  while ((n = gzread(f, buf, sizeof(buf))) > 0) {
    if (out->size() + (size_t)n > kMaxBytes) {
      snprintf(err, 256, "file too large (>4GiB decompressed): %s", path);
      gzclose(f);
      return false;
    }
    out->insert(out->end(), buf, buf + n);
  }
  bool ok = n == 0;
  if (!ok) snprintf(err, 256, "gzread failed for %s", path);
  gzclose(f);
  return ok;
}

}  // namespace

extern "C" {

// ABI handshake: the ctypes wrapper refuses to call into a library whose
// version differs from the one its argtypes describe (a stale .so + new
// wrapper would otherwise corrupt memory — e.g. the expect-dims parameter
// added to fn_read_case). Bump on EVERY exported-signature or struct change.
enum { FN_ABI_VERSION = 2 };
int fn_abi_version(void) { return FN_ABI_VERSION; }

struct FNInfo {
  int64_t dims[3];
  double sum, sumsq;
  int64_t nonzero;
  int64_t bbox_lo[3], bbox_hi[3];  // half-open; hi<=lo => empty
  int32_t ok;
  char err[256];
};

// Probe dims so the caller can allocate. Returns 0 on success.
int fn_probe(const char* path, int64_t dims[3]) try {
  char err[256];
  std::vector<unsigned char> bytes;
  // header is at the front; but gz needs sequential read — read all (cheap
  // enough; probe is used once per case shape, typically constant 240^3)
  if (!slurp(path, &bytes, err)) return 1;
  Header h;
  if (!parse_header(bytes.data(), bytes.size(), &h, err)) return 2;
  dims[0] = h.nx;
  dims[1] = h.ny;
  dims[2] = h.nz;
  return 0;
} catch (...) {
  // no exception may cross the C ABI (std::terminate); bad_alloc from a
  // hostile header or OOM becomes an ordinary failure code
  return 3;
}

// Decode one volume into an interleaved float32 canvas:
//   out[((x*ny + y)*nz + z)*stride + offset]
// accumulating nonzero stats + bbox. stride/offset implement channel
// interleave ((X,Y,Z,C) with stride=C, offset=channel).
//
// `expect` (nullable): expected [nx,ny,nz]. The output buffer is sized by the
// caller from a probe of one file; a case whose other modalities carry
// different header dims would otherwise write out of bounds (heap
// corruption). When expect is non-null and any dim differs, fail BEFORE
// touching `out`.
int fn_read_volume(const char* path, float* out, int64_t stride,
                   int64_t offset, const int64_t* expect, FNInfo* info) try {
  info->ok = 0;
  std::vector<unsigned char> bytes;
  if (!slurp(path, &bytes, info->err)) return 1;
  Header h;
  if (!parse_header(bytes.data(), bytes.size(), &h, info->err)) return 2;
  const int64_t nx = h.nx, ny = h.ny, nz = h.nz, n = nx * ny * nz;
  info->dims[0] = nx;
  info->dims[1] = ny;
  info->dims[2] = nz;
  if (expect && (nx != expect[0] || ny != expect[1] || nz != expect[2])) {
    snprintf(info->err, 256,
             "dims mismatch: header (%lld,%lld,%lld) vs expected (%lld,%lld,%lld)",
             (long long)nx, (long long)ny, (long long)nz, (long long)expect[0],
             (long long)expect[1], (long long)expect[2]);
    return 5;
  }
  size_t esize;
  switch (h.datatype) {
    case 2: esize = 1; break;    // uint8
    case 4: esize = 2; break;    // int16
    case 8: esize = 4; break;    // int32
    case 16: esize = 4; break;   // float32
    case 64: esize = 8; break;   // float64
    case 512: esize = 2; break;  // uint16
    default:
      snprintf(info->err, 256, "unsupported datatype %d", h.datatype);
      return 3;
  }
  if (bytes.size() < (size_t)h.vox_offset + n * esize) {
    snprintf(info->err, 256, "truncated data");
    return 4;
  }
  const unsigned char* data = bytes.data() + h.vox_offset;
  // NaN scl fields mean "unset" — mirror the Python reader's semantics
  // (utils/nifti.py treats NaN slope as 1.0 and NaN inter as 0.0) so the two
  // ingest backends agree on such files.
  const float raw_slope = std::isnan(h.scl_slope) ? 1.0f : h.scl_slope;
  const float raw_inter = std::isnan(h.scl_inter) ? 0.0f : h.scl_inter;
  const bool scale =
      (raw_slope != 0.0f && raw_slope != 1.0f) || (raw_inter != 0.0f);
  const float slope = (raw_slope == 0.0f) ? 1.0f : raw_slope;
  const float inter = raw_inter;

  double sum = 0.0, sumsq = 0.0;
  int64_t nonzero = 0;
  int64_t lo[3] = {nx, ny, nz}, hi[3] = {0, 0, 0};

  // pass 1: bulk dtype decode to a Fortran-ordered float32 temp — tight
  // per-dtype loops the compiler vectorizes (the per-voxel switch version
  // measured ~4x slower); stats/bbox accumulate here where reads are
  // sequential. bbox per-axis via any-hit rows/planes is folded in below.
  std::vector<float> temp((size_t)n);
  auto decode_all = [&](auto tag) {
    using T = decltype(tag);
    const T* src = reinterpret_cast<const T*>(data);
    if (h.swapped) {
      for (int64_t i = 0; i < n; ++i) {
        float v = (float)bswap(src[i]);
        temp[i] = scale ? v * slope + inter : v;
      }
    } else if (scale) {
      for (int64_t i = 0; i < n; ++i) temp[i] = (float)src[i] * slope + inter;
    } else {
      for (int64_t i = 0; i < n; ++i) temp[i] = (float)src[i];
    }
  };
  switch (h.datatype) {
    case 2: decode_all(uint8_t{}); break;
    case 4: decode_all(int16_t{}); break;
    case 8: decode_all(int32_t{}); break;
    case 16: decode_all(float{}); break;
    case 64: decode_all(double{}); break;
    default: decode_all(uint16_t{}); break;
  }
  // stats + bbox in one sequential sweep (x fastest in F order)
  for (int64_t z = 0; z < nz; ++z) {
    for (int64_t y = 0; y < ny; ++y) {
      const float* row = temp.data() + y * nx + z * nx * ny;
      for (int64_t x = 0; x < nx; ++x) {
        const float v = row[x];
        if (v != 0.0f) {
          sum += v;
          sumsq += (double)v * v;
          ++nonzero;
          if (x < lo[0]) lo[0] = x;
          if (y < lo[1]) lo[1] = y;
          if (z < lo[2]) lo[2] = z;
          if (x >= hi[0]) hi[0] = x + 1;
          if (y >= hi[1]) hi[1] = y + 1;
          if (z >= hi[2]) hi[2] = z + 1;
        }
      }
    }
  }
  // pass 2: L1-tiled F->C transpose with channel interleave:
  //   out[((x*ny + y)*nz + z)*stride + offset] = temp[x + y*nx + z*nx*ny]
  constexpr int64_t TB = 32;
  for (int64_t y = 0; y < ny; ++y) {
    for (int64_t zb = 0; zb < nz; zb += TB) {
      const int64_t ze = zb + TB < nz ? zb + TB : nz;
      for (int64_t xb = 0; xb < nx; xb += TB) {
        const int64_t xe = xb + TB < nx ? xb + TB : nx;
        for (int64_t z = zb; z < ze; ++z) {
          const float* src = temp.data() + y * nx + z * nx * ny;
          for (int64_t x = xb; x < xe; ++x) {
            out[((x * ny + y) * nz + z) * stride + offset] = src[x];
          }
        }
      }
    }
  }
  info->sum = sum;
  info->sumsq = sumsq;
  info->nonzero = nonzero;
  for (int d = 0; d < 3; ++d) {
    info->bbox_lo[d] = nonzero ? lo[d] : 0;
    info->bbox_hi[d] = nonzero ? hi[d] : 0;
  }
  info->ok = 1;
  return 0;
} catch (const std::exception& e) {
  // exception barrier: bad_alloc/length_error from hostile headers or OOM
  // must not cross the C ABI (std::terminate would kill the serving
  // process — and inside fn_read_case's worker threads, any escape is
  // fatal even with a caller-side try)
  info->ok = 0;
  snprintf(info->err, 256, "native decode failed: %s", e.what());
  return 6;
} catch (...) {
  info->ok = 0;
  snprintf(info->err, 256, "native decode failed: unknown exception");
  return 6;
}

// Load a whole case (n files -> interleaved (X,Y,Z,n) float32), one thread
// per file. `expect` = the [nx,ny,nz] the caller allocated `out` for — every
// file's header must match or its decode fails with rc 5 (no OOB write).
// Returns 0 iff every file decoded.
int fn_read_case(const char** paths, int32_t n, float* out,
                 const int64_t* expect, FNInfo* infos, int32_t max_threads) try {
  // Honor the caller's thread cap (the exported ABI advertises it): decode
  // in waves of at most `tcount` concurrent files. n is small (4-5), so
  // with the default cap this is still one thread per file in one wave.
  int32_t tcount = max_threads > 0 ? max_threads : (int32_t)std::thread::hardware_concurrency();
  if (tcount < 1) tcount = 1;
  for (int32_t i0 = 0; i0 < n; i0 += tcount) {
    std::vector<std::thread> threads;
    int32_t hi = i0 + tcount < n ? i0 + tcount : n;
    for (int32_t i = i0; i < hi; ++i) {
      threads.emplace_back(
          [=]() { fn_read_volume(paths[i], out, n, i, expect, &infos[i]); });
    }
    for (auto& t : threads) t.join();
  }
  for (int32_t i = 0; i < n; ++i) {
    if (!infos[i].ok) return 1;
  }
  return 0;
} catch (...) {
  return 2;  // e.g. std::system_error from thread creation; see barrier above
}

}  // extern "C"
