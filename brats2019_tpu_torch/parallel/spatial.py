"""Spatial partitioning of 3D volumes over the mesh (reference:
``brats2019_tpu/parallel/spatial.py``).

* :func:`halo_exchange` / :func:`sharded_conv3d_local` /
  :func:`make_sharded_conv3d`: the X axis of a volume split over the shards,
  each shard padded with its neighbours' edge planes (zeros at the volume's
  edges) before a SAME conv, whose halo rows are then dropped: the unsharded
  conv, bitwise in f32. Within a process a neighbour's plane is a slice
  moved to the shard's device; across processes it is a send/recv
  (``mesh.send_recv``), differentiable both ways.
* :func:`distributed_tile_sweep`: the sliding window's (tile x flip) work
  items striped over the shards (:func:`_stripe_items`, padded with
  zero-weight repeats of the first origin), each shard blending its items
  into a canvas that covers only the ROI the origins span, one ``psum``
  merging the canvases (``mesh.psum``: shard order, then across processes).
* :func:`distributed_cascade_sweep` / :func:`distributed_cascade_ensemble`:
  the flagship cascade over the mesh, sharing :func:`_cascade_member_sweep`:
  the coarse localisation replicated (once per distinct device: every shard
  of a device would compute the same thing), the fine ROI's items striped,
  the TTA reduce in the low-res block form, one ROI-sized ``psum``; the
  ensemble adds each member's normalised ROI probabilities at its own start
  into a canvas sum, in member order, and takes the argmax.

Flip ``f`` of a work item is ``infer/tta.py`` ``FLIPS[f]``, so each shard's
f32 reduction runs in FLIPS order, as the single-device programs' does; the
blend weights make the sum a weighted mean, so labels equal the
single-device programs' except where two classes tie within rounding.

The models run where the shard is: a sweep takes ``nets(device) ->
(fine, coarse)`` (the caller keeps one replica a device), and every conv, IN,
up and down of every shard runs on the hand-written kernels of a CUDA device
(``ops``), the plain versions only on the CPU.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..infer.tta import FLIPS, flip_volume, store_dtype
from .mesh import MeshEnv, psum, send_recv


# ----------------------------------------------------------------- halos --

class _ProcessHalo(torch.autograd.Function):
    """The halo planes that cross a process boundary: this process's last
    shard's right edge goes to the next process (whose first shard pads its
    left with it), its first shard's left edge to the previous one. The
    backward sends each received plane's gradient back to its owner."""

    @staticmethod
    def forward(ctx, env, right_edge, left_edge):
        ctx.env = env
        prev = env.rank - 1 if env.rank > 0 else None
        nxt = env.rank + 1 if env.rank < env.world - 1 else None
        ctx.peers = (prev, nxt)
        from_left = send_recv(env, nxt, right_edge, prev, left_edge)
        from_right = send_recv(env, prev, left_edge, nxt, right_edge)
        zl = torch.zeros_like(left_edge)
        return (from_left if from_left is not None else zl,
                from_right if from_right is not None else zl.clone())

    @staticmethod
    def backward(ctx, g_left, g_right):
        env, (prev, nxt) = ctx.env, ctx.peers
        # the gradient of what came from prev goes back to prev, where it
        # is the gradient of prev's right edge (and likewise for nxt)
        d_right = send_recv(env, prev, g_left.contiguous(), nxt, g_right)
        d_left = send_recv(env, nxt, g_right.contiguous(), prev, g_left)
        return (None,
                d_right if d_right is not None else torch.zeros_like(g_right),
                d_left if d_left is not None else torch.zeros_like(g_left))


def _edge_fill(edge: torch.Tensor, halo: int, axis: int, mode: str,
               outer: bool) -> torch.Tensor:
    """The pad beyond the volume's edge: zeros (a SAME conv's zero pad) or
    the edge plane repeated (the resize's replicate clamp). ``edge`` is the
    shard's ``halo`` outermost planes; ``outer`` picks the outermost one
    (index 0 on the left, the last on the right)."""
    if mode == "zeros":
        return torch.zeros_like(edge)
    if mode != "replicate":
        raise ValueError(f"halo edge mode {mode!r}")
    plane = edge.narrow(axis, 0 if outer else edge.shape[axis] - 1, 1)
    return torch.cat([plane] * halo, axis) if halo > 1 else plane


def halo_exchange(env: MeshEnv, shards: Sequence[torch.Tensor], halo: int,
                  axis: int = 0, edge: str = "zeros") -> List[torch.Tensor]:
    """Pad each local shard along ``axis`` with ``halo`` planes from its
    left neighbour and ``halo`` from its right (:34). Beyond the volume's
    edges: zeros, or with ``edge="replicate"`` the edge plane repeated.
    Returns the padded shards (Xl + 2 halo along ``axis``)."""
    n = env.n_local
    if len(shards) != n:
        raise ValueError(f"halo_exchange: {len(shards)} shards for a mesh of {n}")
    lefts = [s.narrow(axis, 0, halo) for s in shards]
    rights = [s.narrow(axis, s.shape[axis] - halo, halo) for s in shards]
    from_left: List[Optional[torch.Tensor]] = [None] * n
    from_right: List[Optional[torch.Tensor]] = [None] * n
    for j in range(1, n):
        from_left[j] = rights[j - 1].to(shards[j].device)
    for j in range(n - 1):
        from_right[j] = lefts[j + 1].to(shards[j].device)
    if env.multiprocess:
        fl, fr = _ProcessHalo.apply(env, rights[-1], lefts[0])
        from_left[0], from_right[n - 1] = fl, fr
    if env.rank == 0:
        from_left[0] = _edge_fill(lefts[0], halo, axis, edge, True)
    if env.rank == env.world - 1:
        from_right[n - 1] = _edge_fill(rights[n - 1], halo, axis, edge, False)
    return [torch.cat([fl, s, fr], axis)
            for fl, s, fr in zip(from_left, shards, from_right)]


def sharded_conv3d_local(env: MeshEnv, shards: Sequence[torch.Tensor],
                         w: torch.Tensor) -> List[torch.Tensor]:
    """SAME 3^3 conv of an X-sharded volume (:70): each (Xl, Y, Z, Ci)
    shard padded with 1-plane halos (zeros at the volume's edges), convolved
    by ``ops.conv3d`` (the conv kernel on a CUDA shard), the halo rows
    dropped. Bitwise the unsharded conv on the gathered volume in f32."""
    from ..ops import conv3d

    halo = w.shape[0] // 2
    padded = halo_exchange(env, shards, halo) if halo else list(shards)
    return [conv3d(xp[None], w.to(xp.device))[0].narrow(0, halo, s.shape[0])
            for xp, s in zip(padded, shards)]


def split_x(env: MeshEnv, x: torch.Tensor, axis: int = 0) -> List[torch.Tensor]:
    """This process's shards of ``x`` (the whole volume, on every process)
    along ``axis``, each on its shard's device. The extent must divide by
    the mesh size."""
    n = env.n_data
    if x.shape[axis] % n:
        raise ValueError(f"extent {x.shape[axis]} of axis {axis} does not "
                         f"divide over {n} shards")
    xl = x.shape[axis] // n
    return [x.narrow(axis, env.shard_index(j) * xl, xl).to(d)
            for j, d in enumerate(env.devices)]


def gather_x(env: MeshEnv, shards: Sequence[torch.Tensor], axis: int = 0
             ) -> torch.Tensor:
    """The whole volume from every shard (:func:`split_x`'s inverse), on the
    first local device of every process."""
    from .mesh import gather_shards

    return torch.cat(gather_shards(env, shards), axis)


def make_sharded_conv3d(env: MeshEnv) -> Callable:
    """``fn(x (X, Y, Z, Ci), w) -> (X, Y, Z, Co)``: the volume split on X
    over the mesh, the weights on every shard (:84)."""

    def fn(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return gather_x(env, sharded_conv3d_local(env, split_x(env, x), w))

    return fn


# ----------------------------------------------------------------- sweeps --

def _stripe_items(origins: np.ndarray, n_flips: int, n_dev: int
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(tile origin x flip) work items striped over ``n_dev`` shards, padded
    with zero-weight repeats of origins[0] (:239): origins (n_dev, per, 3),
    flips (n_dev, per), valid (n_dev, per). Item i is flip i // T of origin
    i % T, so a shard's items run in FLIPS order."""
    items_o = np.concatenate([origins.astype(np.int32)] * n_flips, axis=0)
    items_f = np.repeat(np.arange(n_flips, dtype=np.int32), origins.shape[0])
    n = items_o.shape[0]
    pad = (-n) % n_dev
    items_o = np.concatenate([items_o, np.tile(items_o[:1], (pad, 1))], axis=0)
    items_f = np.concatenate([items_f, np.zeros((pad,), np.int32)])
    valid = np.concatenate([np.ones((n,), np.float32),
                            np.zeros((pad,), np.float32)])
    per = items_o.shape[0] // n_dev
    return (items_o.reshape(n_dev, per, 3), items_f.reshape(n_dev, per),
            valid.reshape(n_dev, per))


def _flip(x: torch.Tensor, f: int) -> torch.Tensor:
    return flip_volume(x, FLIPS[f])


def _flip_blocks(p: torch.Tensor, f: int) -> torch.Tensor:
    """Low-res block-form flip of (d, h, w, r, r, r, K) probabilities: a
    full-res flip is a low-res flip plus the matching r-block flip."""
    axes = [ax for ax, flag in enumerate(FLIPS[f]) if flag]
    axes += [ax + 3 for ax, flag in enumerate(FLIPS[f]) if flag]
    return torch.flip(p, axes) if axes else p


class _Consts:
    """NumPy constants copied to each device once."""

    def __init__(self, **arrays):
        self.arrays = arrays
        self._on: Dict[Tuple[str, str], torch.Tensor] = {}

    def on(self, name: str, device) -> torch.Tensor:
        key = (name, str(device))
        if key not in self._on:
            with torch.inference_mode(False):
                self._on[key] = torch.from_numpy(
                    np.ascontiguousarray(self.arrays[name])).to(device)
        return self._on[key]


def _on_devices(env: MeshEnv, x: torch.Tensor) -> Dict[torch.device, torch.Tensor]:
    """``x`` on every distinct local device (one copy a device)."""
    return {d: x.to(d) for d in env.local_devices()}


def _chunked(fn: Callable, batch: torch.Tensor, chunk: int = 8) -> List[torch.Tensor]:
    """``fn`` over ``batch`` in chunks of ``chunk`` samples; one output a
    sample."""
    outs: List[torch.Tensor] = []
    for i in range(0, batch.shape[0], chunk):
        outs.extend(fn(batch[i:i + chunk]).unbind(0))
    return outs


def distributed_tile_sweep(
    tile_probs_fn: Callable[[torch.Tensor], torch.Tensor],
    env: MeshEnv,
    vol_shape: Tuple[int, int, int],
    origins: np.ndarray,
    tile: Tuple[int, int, int],
    weight_np: np.ndarray,
    num_classes: int,
    n_flips: int = 1,
) -> Callable:
    """Multi-shard sliding-window inference (:116-236): returns
    ``run(vol (X, Y, Z, C)) -> normalised probs (X, Y, Z, K) f32`` on the
    first shard's device (on every process). Each shard sweeps its striped
    (tile x flip) items, item (o, f) flipping the patch by ``FLIPS[f]``,
    forwarding ``tile_probs_fn`` (called with the patch on the shard's
    device; it must run the model replica there) and unflipping, into an
    ROI-sized canvas; one psum merges them; the normalised ROI is pasted
    into a zero canvas."""
    tile = tuple(int(t) for t in tile)
    roi_lo = origins.min(axis=0).astype(np.int64)
    roi_hi = (origins.max(axis=0) + np.asarray(tile)).astype(np.int64)
    roi = tuple(int(h - l) for l, h in zip(roi_lo, roi_hi))
    rel = (origins - roi_lo[None, :]).astype(np.int32)
    o_sh, f_sh, v_sh = _stripe_items(rel, n_flips, env.n_data)
    consts = _Consts(weight=weight_np.astype(np.float32))

    def run(vol: torch.Tensor) -> torch.Tensor:
        vol_on = _on_devices(env, vol)
        canvases, wsums = [], []
        for j, dev in enumerate(env.devices):
            g = env.shard_index(j)
            v = vol_on[dev]
            roi_vol = v[roi_lo[0]:roi_hi[0], roi_lo[1]:roi_hi[1],
                        roi_lo[2]:roi_hi[2]]
            canvas = torch.zeros(roi + (num_classes,), dtype=torch.float32,
                                 device=dev)
            wsum = torch.zeros(roi + (1,), dtype=torch.float32, device=dev)
            weight = consts.on("weight", dev)
            for (o0, o1, o2), f, valid in zip(o_sh[g].tolist(), f_sh[g].tolist(),
                                              v_sh[g].tolist()):
                sl = (slice(o0, o0 + tile[0]), slice(o1, o1 + tile[1]),
                      slice(o2, o2 + tile[2]))
                patch = _flip(roi_vol[sl], f)
                w = weight * valid
                probs = _flip(tile_probs_fn(patch), f) * w
                canvas[sl] = canvas[sl] + probs
                wsum[sl] = wsum[sl] + w
            canvases.append(canvas)
            wsums.append(wsum)
        canvas = psum(env, canvases)
        wsum = psum(env, wsums)
        full = torch.zeros(tuple(vol.shape[:3]) + (num_classes,),
                           dtype=torch.float32, device=env.first)
        full[roi_lo[0]:roi_hi[0], roi_lo[1]:roi_hi[1],
             roi_lo[2]:roi_hi[2]] = canvas / torch.clamp(wsum, min=1e-8)
        return full

    return run


def _cascade_member_sweep(cfg, canvas: Tuple[int, int, int], num_classes: int,
                          n_dev: int, stem: int = 1):
    """The statics of the cascade decompositions (tile grid, flip striping,
    blend weights, the low-res block form) and ``member_sweep(env, image_on,
    nets) -> (canvas_p, wsum, start)``: one member's coarse localisation
    (once per distinct device) and its ROI's striped (tile x flip) sweep,
    psum-merged, on the first shard's device (:277-388)."""
    from ..infer.tiling import blend_weight, tile_origins
    from ..models.cascade import coarse_locate, lowres_blend_weight

    tile = tuple(cfg.tile)
    roi = tuple(min(r, c) for r, c in zip(cfg.roi_shape, canvas))
    origins_np = np.asarray(tile_origins(roi, tile, cfg.overlap))
    weight_np = blend_weight(tile, cfg.blend, cfg.gaussian_sigma_frac)
    n_flips = 8 if cfg.tta_flips else 1
    store_dt = store_dtype(cfg.tta_precision)
    r = stem
    use_lowres = (cfg.tta_flips and stem > 1
                  and all(t % stem == 0 for t in tile)
                  and all(s % stem == 0 for s in roi)
                  and bool((origins_np % stem == 0).all()))
    o_sh, f_sh, v_sh = _stripe_items(origins_np, n_flips, n_dev)
    if use_lowres:
        w_np = lowres_blend_weight(weight_np, tile, r)
        tile_acc = tuple(t // r for t in tile) + (r, r, r)
        roi_acc = tuple(s // r for s in roi) + (r, r, r)
    else:
        w_np = weight_np
        tile_acc, roi_acc = tile, roi
    consts = _Consts(weight=np.asarray(w_np, np.float32))

    def shard_sweep(dev, g, region, fine):
        canvas_p = torch.zeros(roi_acc + (num_classes,), dtype=torch.float32,
                               device=dev)
        wsum = torch.zeros(roi_acc + (1,), dtype=torch.float32, device=dev)
        weight = consts.on("weight", dev)
        items = list(zip(o_sh[g].tolist(), f_sh[g].tolist(), v_sh[g].tolist()))
        patches = []
        for (o0, o1, o2), f, _ in items:
            patch = region[o0:o0 + tile[0], o1:o1 + tile[1], o2:o2 + tile[2]]
            if cfg.tta_flips:
                # the single-device tta_stack's cast of the input stack
                patch = patch.to(store_dt)
            patches.append(_flip(patch, f))
        if use_lowres:
            outs = _chunked(lambda b: fine(b, subpixel=False),
                            torch.stack(patches))
        else:
            outs = _chunked(fine, torch.stack(patches))
        for ((o0, o1, o2), f, valid), logits in zip(items, outs):
            if use_lowres:
                d, h, w_ = logits.shape[:3]
                p = torch.softmax(logits.reshape(d, h, w_, r, r, r, num_classes)
                                  .float(), dim=-1).to(store_dt)
                p = _flip_blocks(p, f)
                o0, o1, o2 = o0 // r, o1 // r, o2 // r
            else:
                p = torch.softmax(logits.float(), dim=-1)
                if cfg.tta_flips:
                    p = p.to(store_dt)
                p = _flip(p, f)
            sl = (slice(o0, o0 + tile_acc[0]), slice(o1, o1 + tile_acc[1]),
                  slice(o2, o2 + tile_acc[2]))
            wv = weight * valid
            canvas_p[sl] = canvas_p[sl] + p.float() * wv
            wsum[sl] = wsum[sl] + wv
        return canvas_p, wsum

    def member_sweep(env: MeshEnv, image_on, nets):
        located = {}
        for dev in env.local_devices():
            _, coarse = nets(dev)
            located[dev] = coarse_locate(coarse, image_on[dev], cfg, canvas, roi)
        canvases, wsums = [], []
        for j, dev in enumerate(env.devices):
            fine, _ = nets(dev)
            c, w = shard_sweep(dev, env.shard_index(j), located[dev][0], fine)
            canvases.append(c)
            wsums.append(w)
        return (psum(env, canvases), psum(env, wsums),
                located[env.first][1])

    statics = {"o_sh": o_sh, "f_sh": f_sh, "v_sh": v_sh, "w_np": w_np,
               "use_lowres": use_lowres, "roi": roi, "r": r}
    return member_sweep, statics


def _zscored_on(env: MeshEnv, vol_raw: torch.Tensor):
    from ..data.preprocess import zscore

    return {d: zscore(v.float()) for d, v in _on_devices(env, vol_raw).items()}


def distributed_cascade_sweep(nets: Callable, env: MeshEnv, cfg,
                              canvas: Tuple[int, int, int], num_classes: int,
                              stem: int = 1) -> Callable:
    """The flagship cascade over the mesh (:391-481): returns ``run(vol_raw
    (X, Y, Z, C) canvas, nets=None) -> (labels_roi uint8, start int32)`` on
    the first shard's device, the single-device program's contract (the
    z-score runs here; the host pastes the ROI and un-crops). ``nets(dev) ->
    (fine, coarse)`` gives the replicas on a device; ``run(..., nets=)``
    swaps them (serving's hot reload)."""
    from ..models.cascade import labels_from_blocks

    member_sweep, st = _cascade_member_sweep(cfg, canvas, num_classes,
                                             env.n_data, stem=stem)
    default = nets

    def run(vol_raw: torch.Tensor, nets: Optional[Callable] = None):
        canvas_p, wsum, start = member_sweep(env, _zscored_on(env, vol_raw),
                                             nets or default)
        probs = canvas_p / torch.clamp(wsum, min=1e-8)
        labels = torch.argmax(probs, dim=-1).to(torch.uint8)
        if st["use_lowres"]:
            labels = labels_from_blocks(labels, st["r"])
        return labels, start

    return run


def distributed_cascade_ensemble(members: Sequence[Callable], env: MeshEnv, cfg,
                                 canvas: Tuple[int, int, int], num_classes: int,
                                 stem: int = 1) -> Callable:
    """K members, each through the same mesh sweep as
    :func:`distributed_cascade_sweep` (:484-578): each member's own coarse
    ROI, its normalised ROI probabilities added at its start into an f32
    canvas sum in member order, the argmax of the sum (unwritten voxels sum
    to zero: background). Returns ``run(vol_raw, members=None) -> labels
    uint8 (canvas)`` on the first shard's device; ``members`` is a list of
    ``nets(dev) -> (fine, coarse)``."""
    from ..models.cascade import probs_from_blocks

    if not members:
        raise ValueError("distributed_cascade_ensemble needs at least one member")
    member_sweep, st = _cascade_member_sweep(cfg, canvas, num_classes,
                                             env.n_data, stem=stem)
    default = list(members)

    def run(vol_raw: torch.Tensor, members: Optional[Sequence[Callable]] = None):
        image_on = _zscored_on(env, vol_raw)
        acc = torch.zeros(tuple(canvas) + (num_classes,), dtype=torch.float32,
                          device=env.first)
        for nets in (members or default):
            canvas_p, wsum, start = member_sweep(env, image_on, nets)
            probs = canvas_p / torch.clamp(wsum, min=1e-8)
            if st["use_lowres"]:
                probs = probs_from_blocks(probs, st["r"])
            sx, sy, sz = (int(v) for v in start.tolist())
            rx, ry, rz = probs.shape[:3]
            acc[sx:sx + rx, sy:sy + ry, sz:sz + rz] += probs
        return torch.argmax(acc, dim=-1).to(torch.uint8)

    return run
