"""Whole-volume segmentation in plain PyTorch and NumPy, float32: the
reference that judges the labels the program serves.

The semantics are those the configurations state (``perfbench/configs``),
worked out here from the raw volume and the weights alone:

1. host: the brain box (voxels nonzero in any modality), centre-fitted into
   the zero canvas;
2. per-modality z-score over the nonzero voxels;
3. with a cascade: the canvas resized to the coarse grid (the linear kernel
   of ``jax.image.resize`` with antialiasing: when shrinking, the triangle
   widens by the ratio and each output's weights are normalised), the coarse
   U-Net, a voxel is tumour when a tumour class has the highest probability,
   the ROI centred on the tumour's bounding box (the grid's centre when there
   is none), scaled to the canvas and clamped inside it;
4. the fine network (the U-Net, or the one that the file's ``network``
   section names: :mod:`networks`) over the 8 axis flips of the ROI (or of
   every tile of the whole-canvas sweep, blended by a Gaussian weight),
   softmax, un-flipped and averaged; labels are the argmax;
5. postprocessing: foreground components (26-connectivity) under
   ``min_component_voxels`` are cleared, among the 128 components with the
   largest root (largest linear index in the component) -- the program's
   stated rule, under which components past those 128 are kept unmeasured --
   then enhancing tumour (class 3) below ``et_min_voxels`` in all becomes
   necrosis (class 1).

:func:`judge` scores a served answer: the ROI start the program chose and the
labels it returned. A decision is judged by the gap between the reference's
best probability and that of the decision taken, as a served token's logit
is judged against the reference's best: the start by the least gap of coarse
voxels that must flip for a mask to yield it; a voxel served as a tumour
class, where its label differs from the reference's postprocessed label, by
its gap; the voxels served as background where the reference's argmax is a
tumour class by the least gap that explains them as taken as background or
as cleared by the postprocessing (:func:`removal_gap`): near-tie voxels that
flip can cut a cluster from the rest and leave it to the small-component
filter. What the labels keep is judged by the postprocessing's
post-condition (:func:`kept_gap`): a served component under
``min_component_voxels`` that the filter measured, or an enhancing tumour
count in (0, ``et_min_voxels``), must be explained by near-tie voxels, and
a voxel served outside the brain box reads the widest gap, 1.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import networks, unet

FLIPS = tuple(itertools.product((False, True), repeat=3))
MAX_COMPONENTS = 128   # components measured by the postprocessing filter


# ---------------------------------------------------------------- geometry --

@dataclasses.dataclass(frozen=True)
class Geometry:
    """Where a raw volume's brain box sits in the canvas: raw slices
    ``src`` copied to canvas slices ``dst``."""

    src: Tuple[slice, slice, slice]
    dst: Tuple[slice, slice, slice]


def geometry(vol: np.ndarray, canvas) -> Geometry:
    mask = np.any(vol != 0, axis=-1)
    full = mask.shape
    src, dst = [], []
    for ax in range(3):
        other = tuple(a for a in range(3) if a != ax)
        idx = np.flatnonzero(mask.any(axis=other))
        lo, hi = (int(idx[0]), int(idx[-1]) + 1) if idx.size else (0, full[ax])
        s, t = hi - lo, canvas[ax]
        if s <= t:
            off = (t - s) // 2
            src.append(slice(lo, hi))
            dst.append(slice(off, off + s))
        else:
            off = (s - t) // 2
            src.append(slice(lo + off, lo + off + t))
            dst.append(slice(0, t))
    return Geometry(tuple(src), tuple(dst))


def to_canvas(vol: np.ndarray, geo: Geometry, canvas) -> np.ndarray:
    out = np.zeros(tuple(canvas) + vol.shape[3:], dtype=vol.dtype)
    out[geo.dst] = vol[geo.src]
    return out


def observed(geo: Geometry, canvas) -> np.ndarray:
    """Canvas voxels that map back to the raw volume."""
    m = np.zeros(tuple(canvas), dtype=bool)
    m[geo.dst] = True
    return m


# -------------------------------------------------------------- arithmetic --

def zscore(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Per-channel z-score of (X, Y, Z, C) over its nonzero voxels."""
    mask = x != 0
    n = mask.sum((0, 1, 2)).clamp_min(1).float()
    mu = torch.where(mask, x, 0.0).sum((0, 1, 2)) / n
    sd = torch.sqrt(torch.where(mask, (x - mu) ** 2, 0.0).sum((0, 1, 2)) / n)
    return torch.where(mask, (x - mu) / (sd + eps), 0.0)


def resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) weights of a linear resize with antialiasing."""
    scale = n_out / n_in
    inv = 1.0 / scale
    width = max(inv, 1.0)
    pos = (np.arange(n_out) + 0.5) * inv - 0.5
    dist = np.abs(pos[None, :] - np.arange(n_in)[:, None])
    w = np.maximum(0.0, 1.0 - dist / width)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(total > 0, w / np.where(total > 0, total, 1.0), 0.0)
    inside = (pos >= -0.5) & (pos <= n_in - 0.5)
    return np.where(inside[None, :], w, 0.0).astype(np.float32)


def resize(x: torch.Tensor, shape) -> torch.Tensor:
    for ax, n_out in enumerate(shape):
        n_in = x.shape[ax]
        if n_in == n_out:
            continue
        w = torch.from_numpy(resize_weights(n_in, n_out)).to(x.device)
        x = torch.movedim(torch.tensordot(torch.movedim(x, ax, -1), w, dims=1),
                          -1, ax)
    return x


def tile_origins(shape, tile, overlap: float) -> list:
    axes = []
    for s, t in zip(shape, tile):
        if t >= s:
            axes.append([0])
            continue
        stride = max(1, int(round(t * (1.0 - overlap))))
        n = int(np.ceil((s - t) / stride)) + 1
        axes.append(sorted(set(np.round(np.linspace(0, s - t, n)).astype(int))))
    return [tuple(int(v) for v in o) for o in itertools.product(*axes)]


def gaussian_weight(tile, sigma_frac: float) -> np.ndarray:
    ws = []
    for t in tile:
        x = np.arange(t, dtype=np.float64) - (t - 1) / 2.0
        ws.append(np.exp(-0.5 * (x / max(t * sigma_frac, 1.0)) ** 2))
    w = ws[0][:, None, None] * ws[1][None, :, None] * ws[2][None, None, :]
    return np.maximum(w / w.max(), 1e-3)


def postprocess(labels: np.ndarray, min_voxels: int, et_min: int) -> np.ndarray:
    from scipy import ndimage

    out = labels.copy()
    if min_voxels > 1:
        comp, n = ndimage.label(labels > 0, structure=np.ones((3, 3, 3), bool))
        if n:
            ids = np.arange(1, n + 1)
            lin = np.arange(comp.size).reshape(comp.shape)
            roots = np.asarray(ndimage.maximum(lin, comp, ids))
            sizes = np.bincount(comp.ravel(), minlength=n + 1)[1:]
            measured = np.zeros(n, bool)
            measured[np.argsort(-roots, kind="stable")[:MAX_COMPONENTS]] = True
            kill = np.zeros(n + 1, bool)
            kill[1:] = measured & (sizes < min_voxels)
            out[kill[comp]] = 0
    if et_min > 0:
        n_et = int((out == 3).sum())
        if 0 < n_et < et_min:
            out[out == 3] = 1
    return out


def bbox_start(mask: np.ndarray, canvas, roi) -> np.ndarray:
    """ROI start of a coarse-grid tumour mask."""
    out = []
    for ax in range(3):
        other = tuple(a for a in range(3) if a != ax)
        idx = np.flatnonzero(mask.any(axis=other))
        n = mask.shape[ax]
        c = (int(idx[0]) + int(idx[-1]) + 1) // 2 if idx.size else n // 2
        out.append(_start(c, n, canvas[ax], roi[ax]))
    return np.array(out, dtype=np.int64)


def _start(c: int, n: int, size: int, roi: int) -> int:
    centre = int(np.float32(c) * np.float32(size / n))
    return min(max(centre - roi // 2, 0), max(size - roi, 0))


def roi_gap(margin: np.ndarray, start, canvas, roi) -> float:
    """The least gap g such that a coarse mask, taking every voxel of
    ``margin`` > g and none of ``margin`` < -g (``margin``: best tumour
    probability minus background probability), yields ``start`` on each
    axis (each axis on its own). 1.0 when no mask yields it."""
    worst = 0.0
    for ax in range(3):
        other = tuple(a for a in range(3) if a != ax)
        prof = margin.max(axis=other).astype(np.float64)
        n = prof.size
        best = np.inf
        if _start(n // 2, n, canvas[ax], roi[ax]) == int(start[ax]):
            best = max(0.0, prof.max())
        before = np.concatenate([[-np.inf], np.maximum.accumulate(prof)[:-1]])
        after = np.concatenate([np.maximum.accumulate(prof[::-1])[::-1][1:], [-np.inf]])
        for lo in range(n):
            for hi in range(lo, n):
                if _start((lo + hi + 1) // 2, n, canvas[ax], roi[ax]) != int(start[ax]):
                    continue
                cost = max(0.0, -prof[lo], -prof[hi], before[lo], after[hi])
                best = min(best, cost)
        worst = max(worst, min(best, 1.0))
    return float(worst)


# -------------------------------------------------------------- the pipeline --

class Segmenter:
    """The reference pipeline for one configuration (``exp``: the
    configuration file's ``experiment``) on ``device``; with ``quant`` the
    lower-precision control."""

    def __init__(self, exp: dict, fine: Dict[str, np.ndarray],
                 coarse: Optional[Dict[str, np.ndarray]], device,
                 quant: Optional[unet.Quant] = None):
        self.exp, self.inf = exp, exp["infer"]
        self.device, self.quant = torch.device(device), quant
        self.net = networks.reference(exp)
        to = lambda p: {k: torch.as_tensor(np.asarray(v, np.float32)).to(self.device)
                        for k, v in p.items()}
        self.fine = to(fine)
        self.cascade = bool(self.inf["cascade"] and exp.get("coarse_unet"))
        self.coarse = to(coarse) if self.cascade else None
        self.canvas = tuple(self.inf["canvas"])
        self.roi = (tuple(min(r, c) for r, c in zip(self.inf["roi_shape"], self.canvas))
                    if self.cascade else self.canvas)

    @torch.no_grad()
    def prepare(self, vol: np.ndarray):
        geo = geometry(vol, self.canvas)
        z = zscore(torch.from_numpy(to_canvas(vol, geo, self.canvas)).to(self.device))
        return z, geo

    @torch.no_grad()
    def margin(self, z: torch.Tensor) -> np.ndarray:
        """Coarse grid: best tumour probability minus background's."""
        x = resize(z, self.inf["coarse_shape"])[None]
        p = torch.softmax(unet.forward(self.coarse, self.exp["coarse_unet"], x,
                                       self.quant)[0], dim=-1)
        return (p[..., 1:].amax(-1) - p[..., 0]).cpu().numpy()

    def start(self, margin: Optional[np.ndarray]) -> np.ndarray:
        if not self.cascade:
            return np.zeros(3, np.int64)
        return bbox_start(margin > 0, self.canvas, self.roi)

    @torch.no_grad()
    def _tta(self, tile: torch.Tensor) -> torch.Tensor:
        acc = None
        for f in FLIPS:
            axes = [a for a, on in enumerate(f) if on]
            x = torch.flip(tile, axes) if axes else tile
            p = torch.softmax(self.net.forward(self.fine, self.exp["unet"], x[None],
                                               self.quant)[0], dim=-1)
            p = torch.flip(p, axes) if axes else p
            acc = p if acc is None else acc + p
        return acc / len(FLIPS)

    @torch.no_grad()
    def probs(self, z: torch.Tensor, start) -> torch.Tensor:
        """Mean class probabilities over the ROI at ``start`` (the whole
        canvas without a cascade)."""
        region = z[tuple(slice(int(s), int(s) + r) for s, r in zip(start, self.roi))]
        tile = tuple(self.inf["tile"])
        origins = tile_origins(region.shape[:3], tile, self.inf["overlap"])
        if len(origins) == 1 and tuple(region.shape[:3]) == tile:
            return self._tta(region)
        if self.inf["blend"] != "gaussian":
            raise ValueError("the reference blends with the Gaussian weight only")
        w = torch.from_numpy(gaussian_weight(tile, self.inf["gaussian_sigma_frac"])
                             .astype(np.float32)).to(self.device)[..., None]
        acc = None
        wsum = torch.zeros(region.shape[:3] + (1,), device=self.device)
        for o in origins:
            sl = tuple(slice(a, a + t) for a, t in zip(o, tile))
            p = self._tta(region[sl])
            if acc is None:   # the network's class count, as its logits give it
                acc = torch.zeros(region.shape[:3] + p.shape[-1:], device=self.device)
            acc[sl] += p * w
            wsum[sl] += w
        return acc / wsum

    def labels(self, probs: torch.Tensor) -> np.ndarray:
        a = torch.argmax(probs, dim=-1).to(torch.uint8).cpu().numpy()
        return postprocess(a, self.inf["min_component_voxels"],
                           self.inf["et_min_voxels"])


def served_in_canvas(labels_raw: np.ndarray, geo: Geometry, canvas):
    """The served (raw-space) labels mapped back into the canvas, and the
    canvas voxels that the raw volume holds."""
    lab = np.zeros(tuple(canvas), labels_raw.dtype)
    lab[geo.dst] = labels_raw[geo.src]
    return lab, observed(geo, canvas)


def removal_gap(gap0: np.ndarray, candidates: np.ndarray, kept: np.ndarray,
                min_voxels: int) -> float:
    """The least gap that explains the voxels served as background where the
    reference's argmax is a tumour class (``candidates``). The program may
    have taken such a voxel as background (at its ``gap0``: the reference's
    best probability minus background's) or as tumour in a component that
    its postprocessing cleared. A cleared component touches no voxel served
    as tumour (``kept``) and has fewer than ``min_voxels`` voxels, so the
    candidates next to a kept voxel were taken as background, and the rest
    taken as tumour must fall in pieces under ``min_voxels``."""
    from scipy import ndimage

    if not candidates.any():
        return 0.0
    cube = np.ones((3, 3, 3), bool)
    contact = candidates & ndimage.binary_dilation(kept, structure=cube)
    g = float(gap0[contact].max()) if contact.any() else 0.0

    def explained(g: float) -> bool:
        rest = candidates & (gap0 > g)
        if not rest.any():
            return True
        comp, n = ndimage.label(rest, structure=cube)
        return int(np.bincount(comp.ravel())[1:].max()) < min_voxels

    if explained(g):
        return g
    steps = np.unique(gap0[candidates & (gap0 > g)])
    lo, hi = 0, len(steps) - 1          # explained(steps[-1]) holds: nothing is left
    while lo < hi:
        mid = (lo + hi) // 2
        if explained(float(steps[mid])):
            hi = mid
        else:
            lo = mid + 1
    return float(steps[lo])


def _capacity_gap(free: np.ndarray, tgap: np.ndarray, gap0: np.ndarray,
                  need: int) -> float:
    """The least gap g at which the voxels of ``free`` can hold ``need``
    separate components, each of which the program may have taken as tumour
    and cleared; 1.0 when no g does. At g a voxel is background where
    ``tgap`` > g, tumour where ``gap0`` (the best probability minus
    background's) > g, and either where both are <= g (a near tie). The
    count at g is the larger of two takings open to the program, so it
    never exceeds what the program could have made: every voxel that may be
    tumour, and the forced ones with the near ties that touch none of them,
    the near ties along a forced voxel taken as background (a near tie
    taken as background can cut a component in two). The count is not
    monotone in g, so g climbs a ladder of ratio 1.25 from 1e-4 to the
    first rung that holds enough, then is bisected over the gaps that occur
    since the rung below. ``free`` lies after a linear index, so the search
    is cut to the slab of rows from its first."""
    from scipy import ndimage

    rows = np.flatnonzero(free.any(axis=(1, 2)))
    if rows.size == 0:
        return 1.0
    slab = slice(int(rows[0]), int(rows[-1]) + 1)
    free, tgap, gap0 = free[slab], tgap[slab], gap0[slab]
    cube = np.ones((3, 3, 3), bool)

    def count(g: float) -> int:
        may = free & (tgap <= g)
        forced = may & (gap0 > g)
        cut = forced | (may & ~ndimage.binary_dilation(forced, structure=cube))
        return max(ndimage.label(may, structure=cube)[1],
                   ndimage.label(cut, structure=cube)[1])

    ladder = [0.0] + list(1e-4 * 1.25 ** np.arange(42)) + [1.0]
    for lo_g, hi_g in zip([0.0] + ladder, ladder):
        if count(hi_g) >= need:
            break
    else:
        return 1.0
    if hi_g == 0.0:
        return 0.0
    vals = np.concatenate([tgap[free], gap0[free]])
    steps = np.unique(vals[(vals > lo_g) & (vals <= hi_g)])
    lo, hi = 0, len(steps) - 1
    while lo < hi:
        mid = (lo + hi) // 2
        if count(float(steps[mid])) >= need:
            hi = mid
        else:
            lo = mid + 1
    return float(steps[lo]) if steps.size else float(hi_g)


def kept_gap(served: np.ndarray, seen: np.ndarray, tgap: np.ndarray,
             gap0: np.ndarray, etgap: np.ndarray, min_voxels: int,
             et_min: int) -> Dict[str, float]:
    """The least gap that explains what the served labels keep against the
    postprocessing's post-condition, in the program's region (``served``
    trusted where ``seen``; ``tgap``: the reference's best probability minus
    its best tumour class's, ``gap0``: minus background's, ``etgap``: minus
    enhancing tumour's).

    The filter clears whole components, so a served foreground component
    under ``min_voxels`` is one the program's filter kept: unmeasured (at
    least 128 components of the program's labels had larger roots), or
    joined to a larger one through voxels the labels do not show. It is
    explained at the least of: the gap at which voxels neither served as
    tumour nor next to it, with larger linear indices, hold the components
    that the served ones with larger roots lack of 128 (cleared ones, taken
    as tumour by the program: :func:`_capacity_gap`); and the least ``tgap`` of an unseen voxel next
    to it. An enhancing tumour count in (0, ``et_min``) is explained by
    unseen voxels taken as enhancing tumour, at the gap of the one that
    makes up the count."""
    from scipy import ndimage

    cube = np.ones((3, 3, 3), bool)
    fg = seen & (served > 0)
    comp, n = ndimage.label(fg, structure=cube)
    small_gap, measured_small = 0.0, 0
    if n and min_voxels > 1:
        ids = np.arange(1, n + 1)
        lin = np.arange(comp.size).reshape(comp.shape)
        roots = np.asarray(ndimage.maximum(lin, comp, ids), np.int64)
        sizes = np.bincount(comp.ravel(), minlength=n + 1)[1:]
        order = np.argsort(-roots, kind="stable")          # rank j: j larger roots
        unseen_t = np.where(seen, np.inf, tgap)
        joined = ndimage.minimum_filter(unseen_t, size=3, mode="constant", cval=np.inf)
        free = ~ndimage.binary_dilation(fg, structure=cube)
        measured_small = int((sizes[order[:MAX_COMPONENTS]] < min_voxels).sum())
        for j, c in enumerate(order[:MAX_COMPONENTS]):
            if sizes[c] >= min_voxels:
                continue
            need = MAX_COMPONENTS - j
            b = float(np.min(joined[comp == c + 1]))
            if b <= small_gap:
                continue
            a = _capacity_gap(free & (lin > roots[c]), tgap, gap0, need)
            small_gap = max(small_gap, min(a, b, 1.0))
            if a <= small_gap:       # later components need no more
                break
    et_gap = 0.0
    n_et = int((seen & (served == 3)).sum())
    if et_min > 0 and 0 < n_et < et_min:
        k = et_min - n_et
        vals = etgap[~seen]
        et_gap = float(np.partition(vals, k - 1)[k - 1]) if vals.size >= k else 1.0
    return {"small_gap": min(small_gap, 1.0), "et_gap": min(et_gap, 1.0),
            "components": int(n), "measured_small": measured_small}


@torch.no_grad()
def judge(ref: Segmenter, z: torch.Tensor, geo: Geometry, margin,
          start, labels_canvas: np.ndarray, seen: np.ndarray) -> Dict[str, float]:
    """Score an answer: ``start`` (the ROI start taken) and
    ``labels_canvas`` (labels in the canvas, trusted where ``seen``). A voxel
    served as a tumour class is judged by its gap; a voxel served as
    background where the reference's argmax is tumour, by
    :func:`removal_gap`."""
    start = np.asarray(start, np.int64).reshape(3)
    if ref.cascade:
        g_roi = roi_gap(margin, start, ref.canvas, ref.roi)
    else:
        g_roi = 0.0 if not start.any() else 1.0
    limit = np.array(ref.canvas) - np.array(ref.roi)
    start = np.clip(start, 0, limit)
    p = ref.probs(z, start)
    best = torch.argmax(p, dim=-1).to(torch.uint8).cpu().numpy()
    r = postprocess(best, ref.inf["min_component_voxels"], ref.inf["et_min_voxels"])
    sl = tuple(slice(int(s), int(s) + n) for s, n in zip(start, ref.roi))
    served, seen = labels_canvas[sl], seen[sl]
    top = p.amax(-1)
    gap = (top - torch.gather(p, -1, torch.from_numpy(served.astype(np.int64)).to(
        p.device)[..., None].clamp(0, p.shape[-1] - 1))[..., 0]).cpu().numpy()
    gap0 = (top - p[..., 0]).cpu().numpy()
    diff = seen & (served != r)
    tumour = diff & (served > 0)
    g_label = float(gap[tumour].max()) if tumour.any() else 0.0
    cleared = seen & (served == 0) & (best > 0)
    g_clear = removal_gap(np.where(r > 0, gap0, 0.0), cleared, seen & (served > 0),
                          ref.inf["min_component_voxels"])
    tgap = (top - p[..., 1:].amax(-1)).cpu().numpy()
    etgap = (top - p[..., 3]).cpu().numpy() if p.shape[-1] > 3 else np.ones_like(tgap)
    kept = kept_gap(served, seen, tgap, gap0, etgap, ref.inf["min_component_voxels"],
                    ref.inf["et_min_voxels"])
    g_kept = max(kept["small_gap"], kept["et_gap"])
    return {"gap": max(g_roi, g_label, g_clear, g_kept), "roi_gap": g_roi,
            "label_gap": g_label, "clear_gap": g_clear, "kept_gap": g_kept,
            "mismatched": int(diff.sum()), "voxels": int(seen.sum()),
            "components": kept["components"], "measured_small": kept["measured_small"]}


def judge_served(ref: Segmenter, vol: np.ndarray, labels_raw: np.ndarray,
                 start) -> Dict[str, float]:
    """:func:`judge` of one served volume: the labels the program returned
    (raw space) and the ROI start it took."""
    z, geo = ref.prepare(vol)
    margin = ref.margin(z) if ref.cascade else None
    lab, seen = served_in_canvas(labels_raw, geo, ref.canvas)
    out = judge(ref, z, geo, margin, start, lab, seen)
    outside = np.ones(labels_raw.shape, bool)
    outside[geo.src] = False
    out["outside"] = int(np.count_nonzero(labels_raw[outside]))
    if out["outside"]:
        out["gap"] = 1.0
    return out


def judge_control(ref: Segmenter, ctl: Segmenter, vol: np.ndarray) -> Dict[str, float]:
    """The control in the program's place: ``ctl`` (the reference in a lower
    precision) decides the start and the labels, ``ref`` judges them."""
    z, geo = ref.prepare(vol)
    margin = ref.margin(z) if ref.cascade else None
    start = ctl.start(ctl.margin(z) if ctl.cascade else None)
    lab = np.zeros(ref.canvas, np.uint8)
    sl = tuple(slice(int(s), int(s) + n) for s, n in zip(start, ref.roi))
    lab[sl] = ctl.labels(ctl.probs(z, start))
    return judge(ref, z, geo, margin, start, lab, observed(geo, ref.canvas))
