"""Connected components on the device by two-phase label propagation
(reference: ``brats2019_tpu/ops/connected_components.py``, plain
``lax.reduce_window`` / ``top_k`` there, plain torch here).

1. seed every foreground voxel with its linear index + 1;
2. phase 1: id <- 26-neighbourhood max, up to ``max_pool_iters`` times or
   until nothing changes;
3. phase 2, entered only when phase 1 hit its cap without converging
   (serpentine paths): pool + pointer jump (id <- id[id]) rounds;
4. sizes without a histogram over all voxels: the root ids (voxels whose seed
   equals their label) by ``topk``, a count per root, mapped back per voxel.
   Components beyond ``max_components`` read 2^30 and are kept by the filter.

The ids, sizes and filtered labels equal the reference's. What differs is how
they are reached:

* ``F.max_pool3d`` has no int32 kernel on CUDA, so ids are pooled as f32; they
  stay below 2^24 (6.9 M on the whole (192,224,160) canvas), hence exact, and
  leave as int32.
* the reference's ``lax.while_loop`` tests for a change every iteration on the
  device; eagerly that is a host sync per iteration. Phase 1 here tests every
  ``check_every`` iterations whether the last one still changed anything. A
  converged labelling is a fixed point, so the extra iterations change
  nothing, the cap falls on a multiple of ``check_every``, and the flag handed
  to phase 2 is the reference's. Under ``torch.export`` both phases become
  ``torch._higher_order_ops.while_loop``s with the same chunks, so an
  exported program gives the same ids.
* the sizes use ``searchsorted`` and a histogram of the matched voxels over
  the roots (a static shape: no host read) instead of the reference's
  chunked compare-sum (a TPU economy).

Each host read of the eager form is a ``cc.sync`` span with device edges
(``utils/profile.py``): the time the stream stands empty while the host
waits for the flag and enqueues nothing.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..utils import profile

BIG = 2 ** 30


def _maxpool3(x: torch.Tensor) -> torch.Tensor:
    """26-neighbourhood max (3^3 window, stride 1, SAME) on (D, H, W) f32."""
    return F.max_pool3d(x[None, None], 3, stride=1, padding=1)[0, 0]


def _pool_passes(labels: torch.Tensor, fg: torch.Tensor, zero: torch.Tensor,
                 n: int):
    """``n`` phase-1 iterations: (labels, whether the last one changed
    anything, as a device bool)."""
    prev = labels
    for _ in range(n):
        prev = labels
        labels = torch.where(fg, _maxpool3(prev), zero)
    return labels, (labels != prev).any()


def _jump_round(labels: torch.Tensor, fg: torch.Tensor,
                zero: torch.Tensor) -> torch.Tensor:
    """One phase-2 round: pool, then id <- max(id, id[id])."""
    pooled = torch.where(fg, _maxpool3(labels), zero)
    flat = pooled.reshape(-1)
    idx = (flat.long() - 1).clamp_min(0)
    jumped = torch.where(flat > 0, flat[idx], zero)
    return torch.maximum(flat, jumped).reshape(pooled.shape)


def label_components(fg: torch.Tensor, max_pool_iters: int = 192,
                     max_jump_rounds: int = 64,
                     check_every: int = 8) -> torch.Tensor:
    """Label the connected components (26-connectivity) of a boolean mask
    (D, H, W). Returns int32 ids, 0 = background, one id per component: the
    largest linear index in it + 1. Traced (``torch.export``), both phases
    are ``while_loop``s whose conditions stay on the device
    (:func:`_label_traced`); the ids are the same."""
    if fg.numel() + 1 >= 2 ** 24:
        raise ValueError(
            f"label_components: {fg.numel()} voxels do not fit exact f32 ids")
    fg = fg.bool()
    seeds = torch.arange(1, fg.numel() + 1, dtype=torch.float32,
                         device=fg.device).reshape(fg.shape)
    zero = torch.zeros((), dtype=torch.float32, device=fg.device)
    labels = torch.where(fg, seeds, zero)
    if torch.compiler.is_compiling():
        return _label_traced(labels, fg, zero, max_pool_iters,
                             max_jump_rounds, check_every)

    changed = True
    it = 0
    while changed and it < max_pool_iters:
        n = min(check_every, max_pool_iters - it)
        labels, flag = _pool_passes(labels, fg, zero, n)
        it += n
        with profile.span("cc.sync", device_edges=True):
            changed = bool(flag)

    rounds = 0
    while changed and rounds < max_jump_rounds:
        new = _jump_round(labels, fg, zero)
        flag = (new != labels).any()
        with profile.span("cc.sync", device_edges=True):
            changed = bool(flag)
        labels = new
        rounds += 1
    return labels.to(torch.int32)


def _label_traced(labels, fg, zero, max_pool_iters: int, max_jump_rounds: int,
                  check_every: int) -> torch.Tensor:
    """The two phases of :func:`label_components` as ``while_loop``s, the
    form ``torch.export`` records: phase 1 runs whole chunks of
    ``check_every`` iterations while the last one changed something, then the
    cap's remainder when it did; phase 2 as eagerly. A converged labelling is
    a fixed point, so running the remainder's iterations unconditionally and
    keeping them only where ``changed`` held gives the eager ids bitwise."""
    from torch._higher_order_ops import while_loop

    dev = labels.device
    chunks, rest = divmod(max_pool_iters, check_every)

    def pool_cond(lab, changed, it):
        return changed & (it < chunks)

    def pool_body(lab, changed, it):
        lab, changed = _pool_passes(lab, fg, zero, check_every)
        return lab, changed, it + 1

    start = (labels, torch.ones((), dtype=torch.bool, device=dev),
             torch.zeros((), dtype=torch.int64, device=dev))
    labels, changed, _ = while_loop(pool_cond, pool_body, start)
    if rest:
        new, flag = _pool_passes(labels, fg, zero, rest)
        labels = torch.where(changed, new, labels)
        changed = changed & flag

    def jump_cond(lab, changed, rounds):
        return changed & (rounds < max_jump_rounds)

    def jump_body(lab, changed, rounds):
        new = _jump_round(lab, fg, zero)
        return new, (new != lab).any(), rounds + 1

    labels, _, _ = while_loop(jump_cond, jump_body, (
        labels, changed, torch.zeros((), dtype=torch.int64, device=dev)))
    return labels.to(torch.int32)


def component_sizes(labels: torch.Tensor,
                    max_components: int = 128) -> torch.Tensor:
    """Per-voxel size (int32) of the voxel's component, 0 on background;
    voxels of components beyond the ``max_components`` largest root ids read
    2^30 (treated as huge: never dropped unmeasured)."""
    flat = labels.reshape(-1).to(torch.int64)
    n = flat.numel()
    seeds = torch.arange(1, n + 1, dtype=torch.int64, device=flat.device)
    roots = torch.where(flat == seeds, flat, torch.zeros_like(flat))
    ids = torch.topk(roots, min(max_components, n)).values   # descending, 0-padded
    asc = ids.flip(0)
    pos = torch.searchsorted(asc, flat).clamp_max(asc.numel() - 1)
    fg = flat > 0
    matched = fg & (asc[pos] == flat)
    # a count per root, of static shape: no host read, and traceable; a
    # histogram skips the unmatched voxels (out of its range), where a
    # scatter_add would send every background voxel's atomic to one count
    k = asc.numel()
    counts = torch.histc(torch.where(matched, pos, -1).float(), bins=k,
                         min=0, max=k).long()
    big = torch.full_like(flat, BIG)
    sizes = torch.where(matched, counts[pos], big)
    sizes = torch.where(fg, sizes, torch.zeros_like(flat))
    return sizes.to(torch.int32).reshape(labels.shape)


def filter_device(labels_in: torch.Tensor, min_voxels: int) -> torch.Tensor:
    """Zero the components of ``labels_in > 0`` smaller than ``min_voxels``
    (the reference's ``_filter_device``)."""
    comp = label_components(labels_in > 0)
    keep = component_sizes(comp) >= min_voxels
    return torch.where(keep, labels_in, torch.zeros_like(labels_in))


def filter_small_components_device(labels: np.ndarray, min_voxels: int,
                                   device="cuda") -> np.ndarray:
    """Device-backed equivalent of ``infer.postprocess``'s
    ``filter_small_components_np`` (26-connectivity), on the card unless the
    caller asks for ``device="cpu"`` (the reference runs it on the default
    device, :166)."""
    if min_voxels <= 1:
        return labels
    t = torch.from_numpy(np.ascontiguousarray(labels)).to(device)
    return filter_device(t, min_voxels).cpu().numpy()


def postprocess_device(labels: torch.Tensor, min_component_voxels: int,
                       et_min_voxels: int) -> torch.Tensor:
    """Small-component removal + tiny-ET suppression on the device (the
    reference's ``models/cascade.py`` ``_postprocess_device``): when
    0 < n_ET < ``et_min_voxels``, ET (3) is relabelled NCR (1)."""
    if min_component_voxels > 1:
        comp = label_components(labels > 0)
        sizes = component_sizes(comp)
        labels = torch.where(sizes >= min_component_voxels, labels,
                             torch.zeros_like(labels))
    if et_min_voxels > 0:
        et = labels == 3
        n_et = et.sum()
        relabel = (n_et > 0) & (n_et < et_min_voxels)
        labels = torch.where(relabel & et, torch.ones_like(labels), labels)
    return labels
