"""Connected components on the device (reference:
``brats2019_tpu/ops/connected_components.py``, plain ``lax.reduce_window`` /
``top_k`` there; it has no Pallas kernel).

:func:`label_components` labels the 26-connected components of a boolean
mask: every foreground voxel reads its component's largest linear index + 1,
background 0. It calls the ``torch.library`` operator
``brats_torch::label_components`` (``ops/library.py``), which takes one of
two routes by the tensor's device:

* CPU, the plain form (:func:`_label_plain`), the reference's two-phase
  propagation:

  1. seed every foreground voxel with its linear index + 1;
  2. phase 1: id <- 26-neighbourhood max, up to ``max_pool_iters`` times or
     until nothing changes;
  3. phase 2, entered only when phase 1 hit its cap without converging
     (serpentine paths): pool + pointer jump (id <- max(id, id[id])) rounds,
     up to ``max_jump_rounds``.

  ``F.max_pool3d`` has no int32 kernel, so ids are pooled as f32; they stay
  below 2^24 (6.9 M on the whole (192,224,160) canvas), hence exact, and
  leave as int32. The reference's ``lax.while_loop`` tests for a change
  every iteration on the device; eagerly that is a host read per iteration.
  Phase 1 here tests every ``check_every`` iterations whether the last one
  still changed anything. A converged labelling is a fixed point, so the
  extra iterations change nothing, the cap falls on a multiple of
  ``check_every``, and the flag handed to phase 2 is the reference's. Each
  host read is a ``cc.sync`` span with device edges (``utils/profile.py``).
* CUDA, the kernel (:func:`label_components_kernel`,
  ``csrc/connected_components.cu``): union-find over 2x2x2 blocks in three
  launches, with no host read. It has no caps and always gives the converged
  labelling (each component's largest linear index + 1). That is the
  reference's result wherever the reference's phase 2 converges; its
  pointer jumping is meant to take O(log diameter) rounds, under the cap of
  64. The card tests hold the two routes bitwise equal at the default caps
  on every mask of ``tests/cc_masks.py`` and on the whole canvas (random
  masks at foreground shares 0.05 and 0.5, a serpentine that needs phase 2),
  and ``chip_smoke.py`` phase 12 on the cohort's canvases; there the ids,
  the sizes and the filtered labels on the card are those of the CPU form.
  Where a caller's caps stop phase 2 short, the routes differ: the CPU
  returns the capped labelling and the card the converged one
  (``test_label_components_kernel_ignores_the_plain_caps``). Every caller
  in the port leaves the caps at their defaults.
  ``label_components.launches`` counts its calls.

Traced (``torch.export``), the operator is one node (its fake gives int32 of
the mask's shape), which takes the route of the device the program runs on.

:func:`component_sizes` measures the components without a histogram over all
voxels: the root ids (voxels whose seed equals their label) by ``topk``, a
count per root by ``searchsorted`` and a histogram of the matched voxels (a
static shape: no host read, where the reference has a chunked compare-sum,
a TPU economy), mapped back per voxel. Components beyond ``max_components``
read 2^30 and are kept by the filter.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from . import _build, library
from ..utils import profile

BIG = 2 ** 30

_SIG = {"label_components_3d": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
        + [ctypes.c_void_p]}


def _lib() -> ctypes.CDLL:
    return _build.load_library("connected_components",
                               ["connected_components.cu"], _SIG)


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


def _label_plain(fg: torch.Tensor, max_pool_iters: int, max_jump_rounds: int,
                 check_every: int) -> torch.Tensor:
    """The plain form, the operator's CPU implementation: the two phases of
    the module docstring on a boolean (D, H, W) mask."""
    seeds = torch.arange(1, fg.numel() + 1, dtype=torch.float32,
                         device=fg.device).reshape(fg.shape)
    zero = torch.zeros((), dtype=torch.float32, device=fg.device)
    labels = torch.where(fg, seeds, zero)

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


def label_components_kernel(fg: torch.Tensor, max_pool_iters: int,
                            max_jump_rounds: int,
                            check_every: int) -> torch.Tensor:
    """The operator's CUDA implementation: ``csrc/connected_components.cu``
    on a contiguous boolean (D, H, W) mask, on the current stream. The caps
    bound the plain form's work and are not read: the kernel always reaches
    the converged labelling (module docstring)."""
    what = "label_components_kernel"
    if fg.device.type != "cuda":
        raise RuntimeError(f"{what}: needs a CUDA tensor, not {fg.device}")
    if fg.dtype != torch.bool:
        raise TypeError(f"{what}: needs a bool mask, not {fg.dtype}")
    if fg.dim() != 3:
        raise ValueError(f"{what}: needs a (D, H, W) mask, not {tuple(fg.shape)}")
    if not fg.is_contiguous():
        raise ValueError(f"{what}: the mask must be contiguous")
    out = torch.empty(fg.shape, dtype=torch.int32, device=fg.device)
    if fg.numel() == 0:
        return out
    d, h, w = fg.shape
    n = -(-d // 2) * -(-h // 2) * -(-w // 2)
    # a 2x2x2 block's parent and key (int32) and occupancy (a byte)
    scratch = torch.empty(2 * n + -(-n // 4), dtype=torch.int32,
                          device=fg.device)
    with torch.cuda.device(fg.device):
        stream = torch.cuda.current_stream(fg.device).cuda_stream
        rc = _lib().label_components_3d(fg.data_ptr(), out.data_ptr(),
                                        scratch.data_ptr(), d, h, w, stream)
    _build.check(rc, "label_components (connected_components.cu)")
    _build.count_launch(label_components)
    return out


def _label_fake(fg: torch.Tensor, max_pool_iters: int, max_jump_rounds: int,
                check_every: int) -> torch.Tensor:
    return fg.new_empty(fg.shape, dtype=torch.int32)


# the three ints are the plain form's caps and check interval: the CPU
# implementation reads them, the CUDA one does not
label_components_op = library.define_op(
    "label_components",
    "(Tensor fg, int max_pool_iters, int max_jump_rounds, int check_every)"
    " -> Tensor",
    _label_plain, label_components_kernel, _label_fake)


def label_components(fg: torch.Tensor, max_pool_iters: int = 192,
                     max_jump_rounds: int = 64,
                     check_every: int = 8) -> torch.Tensor:
    """Label the connected components (26-connectivity) of a boolean mask
    (D, H, W). Returns int32 ids, 0 = background, one id per component: the
    largest linear index in it + 1. The caps and the check interval bound
    the plain form's work on the CPU; the kernel on a CUDA tensor does not
    read them (module docstring)."""
    if fg.numel() + 1 >= 2 ** 24:
        raise ValueError(
            f"label_components: {fg.numel()} voxels do not fit exact f32 ids")
    return label_components_op(fg.bool().contiguous(), max_pool_iters,
                               max_jump_rounds, check_every)


label_components.launches = 0


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
