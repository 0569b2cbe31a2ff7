"""Knowledge distillation (reference: ``brats2019_tpu/train/distill.py``,
:29-110; the method of arXiv:2002.03688): a teacher ensemble's
temperature-softened probabilities supervise a student beside the
ground-truth loss,

    L = gt_weight * seg_loss(student, y) + kd_weight * T^2 * KL(teacher_T || student_T),

the KL averaged over voxels. The KD microbatch loss plugs into
``train_update`` / ``TrainStep`` (``train/step.py``), so distillation shares
the sampling, ``grad_accum_steps`` and the optimizer with plain training.
Teachers are ``UNet3D`` modules built once on the student's device, in eval
mode with ``requires_grad_(False)``, run under ``torch.no_grad()``; their
logits are taken to f32 before ``softmax(logits / T)`` and averaged in
teacher order. One student forward, at full resolution, serves both terms.

On a mesh whose shards sit on several distinct devices, each device gets its
own frozen replica of every teacher (:func:`teacher_replicas`, as the
reference replicates the teacher params on the mesh, ``train/loop.py``
:172-178), and each shard's loss runs the replicas on its own device: the
loss looks them up by the device of its input.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Dict, Mapping, Sequence

import numpy as np
import torch

from ..configs.presets import TrainConfig, UNetConfig
from ..parallel.mesh import _as_device
from ..utils.weights import build_network, require_unet
from .loss import segmentation_loss


@dataclasses.dataclass(frozen=True)
class KDConfig:
    kd_weight: float = 1.0
    temperature: float = 2.0
    # weight of the ground-truth (Dice+CE) term; 0 = pure distillation
    gt_weight: float = 1.0


def kd_loss(student_logits: torch.Tensor, teacher_probs_T: torch.Tensor,
            temperature: float) -> torch.Tensor:
    """KL(teacher_T || student_T), mean over voxels, scaled by T^2."""
    t = temperature
    logp_s = torch.log_softmax(student_logits.float() / t, dim=-1)
    kl = (teacher_probs_T * (torch.log(teacher_probs_T.clamp_min(1e-9))
                             - logp_s)).sum(-1)
    return (t * t) * kl.mean()


@torch.no_grad()
def ensemble_teacher_probs(teachers: Sequence[torch.nn.Module],
                           x: torch.Tensor, temperature: float) -> torch.Tensor:
    """Mean temperature-softened probabilities over a teacher ensemble, in
    teacher order."""
    probs = None
    for teacher in teachers:
        out = teacher(x)
        if isinstance(out, tuple):
            out = out[0]
        pt = torch.softmax(out.float() / temperature, dim=-1)
        probs = pt if probs is None else probs + pt
    return probs / len(teachers)


def build_teachers(unet_cfg: UNetConfig,
                   params: Sequence[Dict[str, np.ndarray]],
                   device) -> list:
    """One frozen ``UNet3D`` per flat export dict, on ``device``."""
    require_unet(unet_cfg, "knowledge distillation")
    return [build_network(unet_cfg, p, device) for p in params]


def teacher_replicas(teachers: Sequence[torch.nn.Module],
                     devices) -> Dict[torch.device, list]:
    """``{device: [teachers]}`` over ``devices`` (a mesh's
    ``local_devices()``, or the one training device): a teacher already on a
    device serves there as it is, elsewhere a frozen copy (eval mode, no
    grad) is made on the device. The originals are not touched."""
    out = {}
    for dev in map(_as_device, devices):
        out[dev] = [t if next(t.parameters()).device == dev else
                    copy.deepcopy(t).to(dev).eval().requires_grad_(False)
                    for t in teachers]
    return out


def make_kd_microbatch_loss(
        replicas: Mapping[torch.device, Sequence[torch.nn.Module]],
        cfg: TrainConfig, kd: KDConfig,
        deep_supervision: bool = False) -> Callable:
    """``(model, imgs, segs) -> (total, aux)`` for ``train_update``: the
    segmentation loss (with the aux heads' terms under deep supervision) and
    the KD term on the same full-resolution student logits; aux gains
    ``kd_loss`` and ``loss`` is the total. ``replicas``:
    :func:`teacher_replicas`' map, from which each call takes the teachers
    on the device of ``imgs``."""
    if not replicas or not all(replicas.values()):
        raise ValueError("distillation needs at least one teacher")

    def loss(model, imgs, segs):
        t_probs = ensemble_teacher_probs(replicas[imgs.device], imgs,
                                         kd.temperature)
        out = model(imgs, deep_outputs=deep_supervision)
        logits, aux_logits = out if isinstance(out, tuple) else (out, None)
        gt_loss, aux = segmentation_loss(
            logits, segs, dice_weight=cfg.dice_weight, ce_weight=cfg.ce_weight,
            region_weight=cfg.region_weight, aux_logits=aux_logits,
            aux_weight=cfg.deep_supervision_weight)
        l_kd = kd_loss(logits, t_probs, kd.temperature)
        total = kd.gt_weight * gt_loss + kd.kd_weight * l_kd
        return total, dict(aux, kd_loss=l_kd, loss=total)

    return loss
