"""Training steps in plain PyTorch, float32: the reference that judges the
program's first steps.

What a step is, as the configuration states it (the repository's training
recipe, written to optax's semantics):

* sampling, shard 0 of one device: microbatch m of seed s draws from a CPU
  ``torch.Generator`` seeded by ``SeedSequence([s, m])``; per sample, a pool
  case (``randint``), a patch origin (per axis a uniform ``randint``, then a
  ``rand`` < ``fg_prob`` that centres the patch on a row of the case's
  foreground table shifted by a jitter of up to a quarter patch, clipped
  into the volume), then with augmentation three flip bits, an axial
  rotation draw, per-channel scale ``1 + U(-a, a)`` and shift ``U(-b, b)``
  applied to the nonzero voxels, the patch held in the pool's dtype;
* loss: mean over the batch of soft Dice over the tumour classes plus
  cross-entropy, both over the full-resolution logits;
* update: clip the gradient's global norm to ``grad_clip`` (no epsilon), AdamW
  (b1 0.9, b2 0.999, eps 1e-8 outside the root, bias-corrected, decoupled
  weight decay on every parameter), warm-up then cosine learning rate.

:func:`run_steps` runs the first steps from the initial weights and returns
the readings that :func:`compare` holds the program's against.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from . import unet

B1, B2, EPS = 0.9, 0.999, 1e-8


def lr_at(cfg: dict, i: int) -> float:
    decay_steps = max(cfg["steps"], 2)
    lr, frac_end = cfg["lr"], cfg["end_lr_frac"]
    warmup = min(cfg["warmup_steps"], max(cfg["steps"] // 2, 0))

    def cosine(steps, alpha, count):
        count = min(count, steps)
        return lr * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * count / steps))
                     + alpha)

    if warmup <= 0:
        return cosine(decay_steps, frac_end, float(i))
    if i < warmup:
        init = lr / (warmup + 1)
        return (init - lr) * (1 - min(max(i, 0), warmup) / warmup) + lr
    return cosine(decay_steps - warmup, frac_end, float(i - warmup))


def generator(seed: int, micro: int) -> torch.Generator:
    state = np.random.SeedSequence([seed, micro]).generate_state(1, np.uint64)
    return torch.Generator().manual_seed(int(state[0]))


def sample(pool, cfg: dict, seed: int, micro: int):
    """The microbatch's patches, f32 (B, X, Y, Z, C), and labels."""
    gen = generator(seed, micro)
    ri = lambda lo, hi: int(torch.randint(lo, hi, (), generator=gen))
    patch = cfg["patch"]
    imgs, segs = [], []
    for _ in range(cfg["batch_per_device"]):
        ci = ri(0, pool.image.shape[0])
        shape = tuple(pool.image.shape[1:4])
        maxs = [max(v - p, 0) for v, p in zip(shape, patch)]
        uniform = [ri(0, m + 1) for m in maxs]
        take_fg = bool(torch.rand((), generator=gen) < cfg["fg_prob"])
        table = pool.fg_host[ci]
        row = ri(0, table.shape[0])
        jitter = [ri(-(p // 4), p // 4 + 1) for p in patch]
        if take_fg and cfg["fg_prob"] > 0:
            origin = [min(max(int(c) - p // 2 + j, 0), m)
                      for c, p, j, m in zip(table[row], patch, jitter, maxs)]
        else:
            origin = uniform
        sl = tuple(slice(o, o + p) for o, p in zip(origin, patch))
        img = pool.image[ci][sl].float()
        seg = pool.seg[ci][sl].long()
        if cfg["augment"]:
            flips = [bool(b) for b in torch.rand(3, generator=gen) < 0.5]
            ri(0, 4)   # the axial rotation's draw
            c = img.shape[-1]
            u = lambda a: -a + 2 * a * torch.rand(c, generator=gen)
            scale = 1.0 + u(cfg["intensity_scale"])
            shift = u(cfg["intensity_shift"])
            if cfg["gamma_range"] > 0 or cfg["rot90_axial"]:
                raise ValueError("the reference has no gamma or rotation")
            axes = [a for a in range(3) if flips[a]]
            if axes:
                img, seg = torch.flip(img, axes), torch.flip(seg, axes)
            img = torch.where(img != 0, img * scale.to(img.device)
                              + shift.to(img.device), 0.0)
            img = img.to(pool.image.dtype).float()   # held in the pool's dtype
        imgs.append(img)
        segs.append(seg)
    return imgs, segs


def loss_of(logits: torch.Tensor, seg: torch.Tensor, cfg: dict) -> torch.Tensor:
    """Dice over the tumour classes + cross-entropy, of one sample."""
    k = logits.shape[-1]
    p = torch.softmax(logits, dim=-1)
    onehot = F.one_hot(seg, k).float()
    red = tuple(range(logits.dim() - 1))
    dice = (2 * (p * onehot).sum(red) + 1e-5) / ((p + onehot).sum(red) + 1e-5)
    ce = -(onehot * torch.log_softmax(logits, dim=-1)).sum(-1).mean()
    return cfg["dice_weight"] * (1 - dice[1:].mean()) + cfg["ce_weight"] * ce


def norms(d: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in d.items()}


def run_steps(params0: Dict[str, np.ndarray], net: dict, cfg: dict, pool,
              seed: int, steps: int = 3, quant: Optional[unet.Quant] = None,
              keep: Optional[Sequence[int]] = None, device="cuda") -> dict:
    """``steps`` training steps from ``params0``. ``keep`` lists the samples
    of each batch whose loss counts (None: all), the batch mean taken over
    them. Returns the loss of each step, per parameter the norm of the
    first step's gradient before and after clipping, and of the change of
    the parameters after the steps."""
    params = {k: torch.as_tensor(np.asarray(v, np.float32)).to(device)
              .requires_grad_(True) for k, v in params0.items()}
    start = {k: p.detach().clone() for k, p in params.items()}
    mu = {k: torch.zeros_like(p) for k, p in params.items()}
    nu = {k: torch.zeros_like(p) for k, p in params.items()}
    losses, g_raw, g_first, g_host = [], None, None, None
    for step in range(steps):
        imgs, segs = sample(pool, cfg, cfg["seed"], step)
        idx = list(range(len(imgs))) if keep is None else list(keep)
        total = 0.0
        for i in idx:
            logits = unet.forward(params, net, imgs[i][None].to(device), quant)[0]
            loss = loss_of(logits, segs[i].to(device), cfg) / len(idx)
            with unet.full_precision():
                loss.backward()
            total += float(loss.detach())
        losses.append(total)
        with torch.no_grad():
            grads = {k: p.grad for k, p in params.items()}
            norm = torch.stack([g.square().sum() for g in grads.values()]).sum().sqrt()
            if step == 0:
                g_raw = norms(grads)
            if not bool(norm < cfg["grad_clip"]):
                grads = {k: g / norm * cfg["grad_clip"] for k, g in grads.items()}
            if step == 0:
                g_first = norms(grads)
                g_host = {k: g.detach().cpu() for k, g in grads.items()}
            lr = lr_at(cfg, step)
            for k, p in params.items():
                mu[k].mul_(B1).add_(grads[k], alpha=1 - B1)
                nu[k].mul_(B2).add_(grads[k].square(), alpha=1 - B2)
                u = (mu[k] / (1 - B1 ** (step + 1))) / (
                    torch.sqrt(nu[k] / (1 - B2 ** (step + 1))) + EPS)
                p.add_((u + cfg["weight_decay"] * p) * (-lr))
                p.grad = None
    delta = norms({k: params[k].detach() - start[k] for k in params})
    return {"losses": losses, "grad_raw": g_raw, "grad": g_first, "grad_t": g_host,
            "delta": delta}


def _leaf_gaps(got: Dict[str, float], ref: Dict[str, float], keys, reduce=max,
               scale: Optional[Dict[str, float]] = None) -> float:
    """``reduce`` over parameters of |got - ref| / max(s, median s), s the
    reference's norm of the parameter (``scale``, default ``ref``)."""
    scale = ref if scale is None else scale
    med = float(np.median([scale[k] for k in keys]))
    return float(reduce([abs(got[k] - ref[k]) / max(scale[k], med, 1e-30) for k in keys]))


def _worst_leaf(got, ref, keys) -> float:
    return _leaf_gaps(got, ref, keys, max)


def compare(got: dict, ref: dict) -> Dict[str, float]:
    """The numbers compared: the relative gap of the first step's loss (and
    the widest of all the steps'); of a parameter's first gradient norm as
    the optimizer takes it, at the widest, and the median parameter's norm
    of the difference of the two gradients; of a
    parameter's change after the steps, leaving out parameters whose
    reference gradient is under a thousandth of the median parameter's (and
    the median over parameters of that change's gap)."""
    step_gaps = [abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"])]
    keys = list(ref["grad"])
    med = float(np.median([ref["grad_raw"][k] for k in keys]))
    moved = [k for k in keys if ref["grad_raw"][k] >= 1e-3 * med]
    gdiff = {k: float((got["grad_t"][k].double() - ref["grad_t"][k].double()).norm())
             for k in keys}
    return {"loss_gap": step_gaps[0], "loss_gap_steps": max(step_gaps),
            "grad_gap": _worst_leaf(got["grad"], ref["grad"], keys),
            "grad_diff": _leaf_gaps(gdiff, {k: 0.0 for k in keys}, keys, np.median,
                                    scale=ref["grad"]),
            "update_gap": _worst_leaf(got["delta"], ref["delta"], moved),
            "update_gap_median": _leaf_gaps(got["delta"], ref["delta"], moved,
                                            np.median)}
