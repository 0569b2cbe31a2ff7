"""Pure-NumPy NIfTI-1 reader/writer (copy of ``brats2019_tpu/utils/nifti.py``).

The 348-byte header, qform/sform affines, scl_slope/scl_inter scaling,
endianness detection and transparent gzip. Data is Fortran-ordered on disk
(x fastest); arrays are returned C-contiguous and indexed ``[x, y, z]``.
"""

from __future__ import annotations

import dataclasses
import gzip
import io as _io
import os
import struct
from typing import Optional, Tuple

import numpy as np

HDR_SIZE = 348
MAGIC_SINGLE = b"n+1\x00"

# NIfTI-1 datatype code -> numpy dtype
_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
    1024: np.int64,
    1280: np.uint64,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


@dataclasses.dataclass
class NiftiHeader:
    """Decoded subset of the NIfTI-1 header plus the raw bytes for round-trip."""

    dim: Tuple[int, ...]
    datatype: int
    pixdim: Tuple[float, ...]     # pixdim[0:8]; pixdim[0] is qfac
    vox_offset: int
    scl_slope: float
    scl_inter: float
    qform_code: int
    sform_code: int
    quatern: Tuple[float, float, float]       # b, c, d
    qoffset: Tuple[float, float, float]
    srow: np.ndarray              # (3, 4) float32
    byteswapped: bool
    raw: bytes                    # original 348 header bytes (disk byte order)

    @property
    def np_dtype(self) -> np.dtype:
        return np.dtype(_DTYPES[self.datatype])

    def affine(self) -> np.ndarray:
        """4x4 voxel->world affine: sform if set, else qform, else pixdim scale."""
        if self.sform_code > 0:
            aff = np.eye(4, dtype=np.float64)
            aff[:3, :] = self.srow.astype(np.float64)
            return aff
        if self.qform_code > 0:
            return _quatern_to_affine(
                self.quatern, self.qoffset, self.pixdim[1:4], self.pixdim[0]
            )
        return np.diag(
            [self.pixdim[1] or 1.0, self.pixdim[2] or 1.0, self.pixdim[3] or 1.0, 1.0]
        )


def _quatern_to_affine(quatern, qoffset, zooms, qfac) -> np.ndarray:
    b, c, d = (float(q) for q in quatern)
    a = np.sqrt(max(1.0 - (b * b + c * c + d * d), 0.0))
    R = np.array(
        [
            [a * a + b * b - c * c - d * d, 2 * b * c - 2 * a * d, 2 * b * d + 2 * a * c],
            [2 * b * c + 2 * a * d, a * a + c * c - b * b - d * d, 2 * c * d - 2 * a * b],
            [2 * b * d - 2 * a * c, 2 * c * d + 2 * a * b, a * a + d * d - c * c - b * b],
        ],
        dtype=np.float64,
    )
    qfac = -1.0 if qfac < 0 else 1.0
    zooms = np.array([zooms[0] or 1.0, zooms[1] or 1.0, zooms[2] or 1.0])
    aff = np.eye(4)
    aff[:3, :3] = R @ np.diag([zooms[0], zooms[1], qfac * zooms[2]])
    aff[:3, 3] = qoffset
    return aff


class _OwningGzipFile(gzip.GzipFile):
    """GzipFile that also closes the raw file it wraps."""

    def close(self):
        raw = self.fileobj
        try:
            super().close()
        finally:
            if raw is not None:
                raw.close()


def _maybe_gzip_open(path: str) -> _io.BufferedIOBase:
    f = open(path, "rb")
    magic = f.read(2)
    f.seek(0)
    if magic == b"\x1f\x8b":
        return _OwningGzipFile(fileobj=f)  # type: ignore[return-value]
    return f


def _parse_header(hdr_bytes: bytes) -> NiftiHeader:
    if len(hdr_bytes) < HDR_SIZE:
        raise ValueError(f"NIfTI header truncated: {len(hdr_bytes)} < {HDR_SIZE}")
    raw = hdr_bytes[:HDR_SIZE]
    (sizeof_hdr,) = struct.unpack_from("<i", raw, 0)
    swapped = False
    endian = "<"
    if sizeof_hdr != HDR_SIZE:
        (sizeof_hdr_be,) = struct.unpack_from(">i", raw, 0)
        if sizeof_hdr_be != HDR_SIZE:
            raise ValueError(f"Not a NIfTI-1 file (sizeof_hdr={sizeof_hdr})")
        swapped = True
        endian = ">"

    def u(fmt, off):
        return struct.unpack_from(endian + fmt, raw, off)

    dim_full = u("8h", 40)
    ndim = int(dim_full[0])
    if not 1 <= ndim <= 7:
        raise ValueError(f"Bad ndim {ndim}")
    dim = tuple(int(d) for d in dim_full[1 : 1 + ndim])
    if any(d <= 0 for d in dim):
        raise ValueError(f"Bad NIfTI dim {dim}: all extents must be positive")
    (datatype,) = u("h", 70)
    if datatype not in _DTYPES:
        raise ValueError(f"Unsupported NIfTI datatype code {datatype}")
    (vox_offset,) = u("f", 108)
    return NiftiHeader(
        dim=dim,
        datatype=int(datatype),
        pixdim=tuple(float(p) for p in u("8f", 76)),
        vox_offset=int(vox_offset) if vox_offset else HDR_SIZE + 4,
        scl_slope=float(u("f", 112)[0]),
        scl_inter=float(u("f", 116)[0]),
        qform_code=int(u("h", 252)[0]),
        sform_code=int(u("h", 254)[0]),
        quatern=tuple(float(q) for q in u("3f", 256)),
        qoffset=tuple(float(q) for q in u("3f", 268)),
        srow=np.array([u("4f", 280), u("4f", 296), u("4f", 312)], dtype=np.float32),
        byteswapped=swapped,
        raw=raw,
    )


def read_nifti(
    path: str, *, apply_scaling: bool = True, dtype: Optional[np.dtype] = None
) -> Tuple[np.ndarray, NiftiHeader]:
    """Read a ``.nii`` / ``.nii.gz`` file: ``(data [x, y, z], header)``.
    ``apply_scaling`` applies a non-trivial scl_slope/scl_inter in float32."""
    with _maybe_gzip_open(path) as f:
        hdr = _parse_header(f.read(HDR_SIZE))
        if hdr.vox_offset < HDR_SIZE:
            raise ValueError(
                f"Bad NIfTI vox_offset {hdr.vox_offset} (< header size "
                f"{HDR_SIZE}) in {path}"
            )
        f.read(hdr.vox_offset - HDR_SIZE)  # skip extensions
        n_items = int(np.prod(hdr.dim))
        item_dtype = hdr.np_dtype
        buf = f.read(n_items * item_dtype.itemsize)
    if len(buf) < n_items * item_dtype.itemsize:
        raise ValueError(f"NIfTI data truncated in {path}")
    arr = np.frombuffer(buf, dtype=item_dtype, count=n_items)
    if hdr.byteswapped:
        arr = arr.byteswap()
    arr = np.ascontiguousarray(arr.reshape(hdr.dim, order="F"))
    # 3-D volumes written as dim[0]=4 with a singleton 4th axis
    while arr.ndim > 3 and arr.shape[-1] == 1:
        arr = arr[..., 0]
    slope, inter = hdr.scl_slope, hdr.scl_inter
    nontrivial = (slope not in (0.0, 1.0) and not np.isnan(slope)) or (
        inter != 0.0 and not np.isnan(inter)
    )
    if apply_scaling and nontrivial:
        s = 1.0 if (slope == 0.0 or np.isnan(slope)) else slope
        i = 0.0 if np.isnan(inter) else inter
        arr = arr.astype(np.float32) * np.float32(s) + np.float32(i)
    if dtype is not None:
        arr = arr.astype(dtype)
    return arr, hdr


def read_header(path: str) -> NiftiHeader:
    """Only the 348-byte header (the payload-cache hit path needs nothing
    else of the input files)."""
    with _maybe_gzip_open(path) as f:
        return _parse_header(f.read(HDR_SIZE))


def _build_header(shape, dtype: np.dtype, affine: Optional[np.ndarray],
                  descrip: bytes) -> bytes:
    dtype = np.dtype(dtype)
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"Cannot write dtype {dtype}")
    ndim = len(shape)
    dim = [ndim] + list(shape) + [1] * (7 - ndim)
    affine = np.asarray(np.eye(4) if affine is None else affine, dtype=np.float64)
    zooms = np.sqrt((affine[:3, :3] ** 2).sum(axis=0))
    pd = [1.0] + [float(z) if z else 1.0 for z in zooms] + [1.0] * 4

    raw = bytearray(HDR_SIZE)
    struct.pack_into("<i", raw, 0, HDR_SIZE)
    raw[38] = ord("r")  # regular
    struct.pack_into("<8h", raw, 40, *dim)
    struct.pack_into("<2h", raw, 70, _DTYPE_CODES[dtype], dtype.itemsize * 8)
    struct.pack_into("<8f", raw, 76, *pd[:8])
    struct.pack_into("<f", raw, 108, float(HDR_SIZE + 4))
    struct.pack_into("<2f", raw, 112, 1.0, 0.0)  # scl_slope / inter
    d = descrip[:79]
    raw[148 : 148 + len(d)] = d
    struct.pack_into("<2h", raw, 252, 0, 1)  # qform_code=0, sform_code=1
    for row in range(3):
        struct.pack_into("<4f", raw, 280 + 16 * row, *affine[row, :].astype(np.float32))
    raw[344:348] = MAGIC_SINGLE
    return bytes(raw)


def write_nifti(
    path: str,
    data: np.ndarray,
    *,
    affine: Optional[np.ndarray] = None,
    like: Optional[NiftiHeader] = None,
    descrip: bytes = b"brats2019_tpu",
) -> None:
    """Write ``data`` as a single-file NIfTI-1 (.nii or .nii.gz by extension).
    ``like`` reuses an input header with dim, datatype and scaling rewritten
    for ``data``. The file appears whole: written to a temporary name, then
    renamed."""
    data = np.asarray(data)
    if like is not None:
        if like.byteswapped:
            raise ValueError("Cannot reuse a byteswapped header for writing")
        raw = bytearray(like.raw)
        dim = [data.ndim] + list(data.shape) + [1] * (7 - data.ndim)
        struct.pack_into("<8h", raw, 40, *dim)
        code = _DTYPE_CODES[np.dtype(data.dtype)]
        struct.pack_into("<2h", raw, 70, code, data.dtype.itemsize * 8)
        struct.pack_into("<f", raw, 108, float(HDR_SIZE + 4))
        struct.pack_into("<2f", raw, 112, 1.0, 0.0)  # identity scaling for labels
        hdr_bytes = bytes(raw)
    else:
        hdr_bytes = _build_header(data.shape, data.dtype, affine, descrip)

    payload = hdr_bytes + b"\x00" * 4 + np.asfortranarray(data).tobytes(order="F")
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as fo:
        if path.endswith(".gz"):
            # mtime=0 for deterministic bytes
            with gzip.GzipFile(filename="", fileobj=fo, mode="wb", mtime=0,
                               compresslevel=6) as g:
                g.write(payload)
        else:
            fo.write(payload)
    os.replace(tmp, path)
