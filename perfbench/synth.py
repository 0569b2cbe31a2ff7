"""Inputs and weights made from the run's seed, on the device.

* :func:`volumes`: synthetic BraTS cases, the recipe of the repository's
  synthetic generator (v1) rewritten in torch: four modalities of an
  ellipsoidal brain on a zero background (a base intensity, a gradient that
  differs by modality, Gaussian texture), a tumour of three nested ellipsoids
  (oedema > necrosis > enhancing) with a contrast per modality;
* :func:`training_pool`: such cases z-scored over the brain, cropped to it
  and centre-fitted into the pool canvas in bf16, with their labels and a
  table of foreground voxels to centre patches on;
* :func:`params`: a network's weights in one draw per kind: kernels
  truncated normal scaled by 1/sqrt(fan-in) (LeCun), norm scales (names
  ending in ``scale``) 1 + 0.1 N, every other vector, such as the norm and
  head biases, 0.1 N.

Every draw comes from a ``torch.Generator`` on the device, seeded from the
run's seed and a tag, so a seed gives the same inputs and weights on every
run.
"""

from __future__ import annotations

import math
import types
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

TAGS = {"volumes": 1, "pool": 2, "fine": 3, "coarse": 4, "fg": 5}


def generator(seed: int, tag: str, device) -> torch.Generator:
    state = np.random.SeedSequence([int(seed), TAGS[tag]]).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(state[0]))


def _ellipsoid(grids, centre, radii) -> torch.Tensor:
    acc = 0.0
    for g, c, r in zip(grids, centre, radii):
        acc = acc + ((g - c) / max(float(r), 1e-6)) ** 2
    return acc <= 1.0


def _case(g: torch.Generator, shape: Tuple[int, int, int], device):
    """(image (X, Y, Z, 4) f32, labels (X, Y, Z) uint8) of one case."""
    X, Y, Z = shape
    u = torch.rand(12, generator=g, device=device).cpu().tolist()
    grids = [torch.arange(s, device=device, dtype=torch.float32).reshape(
        [-1 if a == ax else 1 for a in range(3)]) for ax, s in enumerate(shape)]
    centre = (X / 2 + 10 * u[0] - 5, Y / 2 + 10 * u[1] - 5, Z / 2)
    radii = (X * 0.35, Y * 0.4, Z * 0.42)
    brain = _ellipsoid(grids, centre, radii)
    gx = torch.linspace(0, 1, X, device=device)[:, None, None]
    gy = torch.linspace(0, 1, Y, device=device)[None, :, None]
    base = torch.tensor([200 + 600 * v for v in u[2:6]], device=device)
    tex = torch.randn(shape + (4,), generator=g, device=device) * (base * 0.05)
    image = torch.empty(shape + (4,), device=device)
    for c in range(4):
        ramp = gx * (c % 2) + gy * ((c + 1) % 2)
        image[..., c] = torch.where(brain, base[c] * (0.8 + 0.2 * ramp) + tex[..., c], 0.0)
    t_centre = tuple(bc + (0.3 * v - 0.15) * br
                     for bc, br, v in zip(centre, radii, u[6:9]))
    r_ed = tuple(max(4.0, 0.30 * r) for r in radii)
    ed = _ellipsoid(grids, t_centre, r_ed) & brain
    ncr = _ellipsoid(grids, t_centre, [0.6 * r for r in r_ed]) & brain
    et = _ellipsoid(grids, t_centre, [0.35 * r for r in r_ed]) & brain
    seg = torch.zeros(shape, dtype=torch.uint8, device=device)
    seg[ed], seg[ncr], seg[et] = 2, 1, 3
    for c, m, delta in ((0, ncr, -0.35), (1, et, 0.6), (2, ed, 0.45), (3, ed, 0.5)):
        image[..., c] = torch.where(m, image[..., c] * (1.0 + delta), image[..., c])
    return image, seg


def volumes(n: int, shape: Sequence[int], seed: int, device) -> list:
    """``n`` raw cases as host float32 arrays (X, Y, Z, 4), made on
    ``device`` one at a time and copied to the host once each."""
    g = generator(seed, "volumes", device)
    out = []
    for _ in range(n):
        out.append(_case(g, tuple(shape), device)[0].cpu().numpy())
    return out


def _zscore(x: torch.Tensor) -> torch.Tensor:
    mask = x != 0
    n = mask.sum((0, 1, 2)).clamp_min(1).double()
    xd = x.double()
    mu = torch.where(mask, xd, 0.0).sum((0, 1, 2)) / n
    sd = torch.sqrt(torch.where(mask, (xd - mu) ** 2, 0.0).sum((0, 1, 2)) / n)
    return torch.where(mask, (xd - mu) / (sd + 1e-6), 0.0).float()


def _fit(x: torch.Tensor, canvas) -> torch.Tensor:
    """Centre-fit ``x``'s first three axes into ``canvas`` (zero-padded, or
    cropped about the centre)."""
    out = torch.zeros(tuple(canvas) + tuple(x.shape[3:]), dtype=x.dtype, device=x.device)
    src, dst = [], []
    for ax, t in enumerate(canvas):
        s = x.shape[ax]
        if s <= t:
            off = (t - s) // 2
            src.append(slice(0, s))
            dst.append(slice(off, off + s))
        else:
            off = (s - t) // 2
            src.append(slice(off, off + t))
            dst.append(slice(0, t))
    out[tuple(dst)] = x[tuple(src)]
    return out


def training_pool(k: int, raw_shape: Sequence[int], canvas: Sequence[int],
                  seed: int, device, fg_rows: int = 4096):
    """A pool of ``k`` cases as the train step reads it: ``image`` (k, X, Y,
    Z, 4) bf16, ``seg`` (k, X, Y, Z) uint8, ``fg_host`` (k, fg_rows, 3) int32
    coordinates of foreground voxels, drawn with replacement."""
    g = generator(seed, "pool", device)
    g_fg = generator(seed, "fg", "cpu")
    images, segs, tables = [], [], []
    for _ in range(k):
        image, seg = _case(g, tuple(raw_shape), device)
        image = _zscore(image)
        nz = (image != 0).any(-1)
        box = []
        for ax in range(3):
            other = tuple(a for a in range(3) if a != ax)
            idx = torch.nonzero(nz.any(other[1]).any(other[0])).flatten()
            box.append(slice(int(idx[0]), int(idx[-1]) + 1))
        image = _fit(image[tuple(box)], canvas).to(torch.bfloat16)
        seg = _fit(seg[tuple(box)], canvas)
        coords = torch.nonzero(seg > 0).cpu()
        if coords.shape[0] == 0:
            coords = torch.tensor([[c // 2 for c in canvas]])
        rows = torch.randint(0, coords.shape[0], (fg_rows,), generator=g_fg)
        images.append(image)
        segs.append(seg)
        tables.append(coords[rows].numpy().astype(np.int32))
    return types.SimpleNamespace(image=torch.stack(images), seg=torch.stack(segs),
                                 fg_host=np.stack(tables))


def params(shapes: Dict[str, Tuple[int, ...]], seed: int, tag: str,
           device) -> Dict[str, torch.Tensor]:
    """f32 weights of the named shapes on ``device``."""
    g = generator(seed, tag, device)
    kernels = [k for k in shapes if k.endswith("kernel")]
    vectors = [k for k in shapes if not k.endswith("kernel")]
    flat_k = torch.empty(sum(math.prod(shapes[k]) for k in kernels), device=device)
    torch.nn.init.trunc_normal_(flat_k, 0.0, 1.0, -2.0, 2.0, generator=g)
    flat_v = torch.empty(sum(math.prod(shapes[k]) for k in vectors), device=device)
    torch.nn.init.trunc_normal_(flat_v, 0.0, 0.1, -0.2, 0.2, generator=g)
    out, off = {}, 0
    for k in kernels:
        n, shape = math.prod(shapes[k]), shapes[k]
        std = math.sqrt(1.0 / math.prod(shape[:-1])) / 0.87962566103423978
        out[k] = (flat_k[off:off + n] * std).reshape(shape)
        off += n
    off = 0
    for k in vectors:
        n = math.prod(shapes[k])
        v = flat_v[off:off + n].reshape(shapes[k])
        out[k] = v + 1.0 if k.endswith("scale") else v.clone()
        off += n
    return {k: out[k] for k in shapes}
