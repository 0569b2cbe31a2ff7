"""The training step, on one device or data-parallel over a mesh (reference:
``brats2019_tpu/train/step.py``).

Written to optax's semantics rather than ``torch.optim``'s defaults, so a
run follows the JAX package's ``make_optimizer`` (:112-136) step for step:

* **schedule** — ``warmup_cosine_decay_schedule`` with init lr/(warmup+1),
  warmup = min(warmup_steps, steps // 2) (cosine decay alone when that is
  0); the lr of step i is the schedule at count i, from 0;
* **clip_by_global_norm** — every grad becomes (g / norm) * max_norm unless
  norm < max_norm; no epsilon;
* **adamw** — b1 0.9, b2 0.999, eps 1e-8 outside the sqrt, bias-corrected
  moments, then weight decay on every parameter, then times -lr;
* **EMA** (``params_ema_tracker`` :42-74) — ema <- decay * ema + (1 - decay)
  * (params + update), initialised to a copy of the initial params.

Gradients accumulate over k microbatches and are divided by k. The logged
``grad_norm`` is the global norm of the unclipped grads (:286).

RNG contract (:147-181), kept here (:func:`step_generator`): the random
numbers of microbatch i of step s on global shard j come from a
``torch.Generator`` seeded by (seed, s * k + i, j) alone, and shard 0's by
(seed, s * k + i), so one shard draws exactly what the one-device step
always drew, resume needs no saved generator state, and the process layout
(``parallel/mesh.py``: j is global) is invisible to sampling. The draws run on
the host; the pool slicing and augmentation run on the pool's device.

Data parallelism (:230-300, ``make_train_step`` over a mesh): each shard
samples its own batch from its own pool, runs its k microbatches' forward and
backward on its device (shards on one device share the model; another
device has a replica whose parameters are copied from the model before each
step), and flattens its accumulated grads, divided by k, into one f32 bucket.
The buckets and the aux are averaged once a step, after accumulation, as the
reference's ``pmean`` (:282-283): one ``mesh.psum`` (the local buckets added
in shard order, then one all-reduce across processes) divided by the number
of shards. DDP is not used: it all-reduces every microbatch unless told
``no_sync``, and it needs a process per device, where a mesh may hold several
shards on one card. The optimizer (and its EMA) stays one replicated copy,
updated on the first shard's device from the averaged grads; every process
computes the same update.

Spans (``utils/profile.py``): ``train.step`` around a step; inside it
``train.sample`` (one per microbatch and shard), ``train.forward`` (the
loss), ``train.backward`` and ``train.update`` (clip, AdamW, EMA).
"""

from __future__ import annotations

import copy
import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..configs.presets import TrainConfig
from ..data.augment import apply_augment, draw_augment
from ..data.sampling import sample_patch_impl
from ..utils import profile
from .loss import segmentation_loss, segmentation_loss_lowres


# ----------------------------------------------------------------- schedule --

def lr_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    """The learning rate at optimizer count i (``make_optimizer``'s
    schedule)."""
    decay_steps = max(cfg.steps, 2)
    end = cfg.lr * cfg.end_lr_frac
    warmup = min(cfg.warmup_steps, max(cfg.steps // 2, 0))

    def cosine(init: float, steps: int, alpha: float, count: float) -> float:
        count = min(count, steps)
        return init * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * count / steps))
                       + alpha)

    if warmup <= 0:
        return lambda i: cosine(cfg.lr, decay_steps, cfg.end_lr_frac, float(i))
    init = cfg.lr / (warmup + 1)
    alpha = 0.0 if cfg.lr == 0.0 else end / cfg.lr

    def schedule(i: int) -> float:
        if i < warmup:
            frac = 1 - min(max(i, 0), warmup) / warmup
            return (init - cfg.lr) * frac + cfg.lr
        return cosine(cfg.lr, decay_steps - warmup, alpha, float(i - warmup))

    return schedule


# ---------------------------------------------------------------- optimizer --

def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.stack([t.float().square().sum() for t in tensors]).sum().sqrt()


class Optimizer:
    """clip_by_global_norm -> adamw -> (EMA) over named f32 parameters,
    updated in place."""

    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, params: Dict[str, torch.nn.Parameter], cfg: TrainConfig):
        if cfg.ema_decay > 0.0 and not 0.0 < cfg.ema_decay < 1.0:
            raise ValueError(f"ema decay must be in (0, 1), got {cfg.ema_decay}")
        self.params = params
        self.cfg = cfg
        self.lr = lr_schedule(cfg)
        self.count = 0
        self.mu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.ema = self.fresh_ema() if cfg.ema_decay > 0.0 else None

    def fresh_ema(self) -> Dict[str, torch.Tensor]:
        return {k: p.detach().clone() for k, p in self.params.items()}

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Apply one update; returns the global norm of ``grads``."""
        cfg = self.cfg
        names = list(self.params)
        g_norm = global_norm([grads[k] for k in names])
        keep = g_norm < cfg.grad_clip
        lr = self.lr(self.count)
        self.count += 1
        bc1 = 1 - self.B1 ** self.count
        bc2 = 1 - self.B2 ** self.count
        for k in names:
            p, g = self.params[k], grads[k].float()
            g = torch.where(keep, g, (g / g_norm) * cfg.grad_clip)
            mu = self.mu[k].mul_(self.B1).add_(g, alpha=1 - self.B1)
            nu = self.nu[k].mul_(self.B2).add_(g.square(), alpha=1 - self.B2)
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.EPS)
            u = (u + cfg.weight_decay * p) * (-lr)
            if self.ema is not None:
                d = cfg.ema_decay
                self.ema[k].mul_(d).add_(p + u, alpha=1.0 - d)
            p.add_(u)
        return g_norm

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": self.mu, "nu": self.nu,
                "ema": self.ema}

    def load_state_dict(self, s: dict) -> Optional[str]:
        """Restore; returns a note when the checkpoint's EMA had to be
        dropped or seeded to match this run's ema_decay."""
        dev = next(iter(self.params.values())).device
        to = lambda d: {k: v.to(dev) for k, v in d.items()}
        self.count = int(s["count"])
        self.mu, self.nu = to(s["mu"]), to(s["nu"])
        note = None
        if self.cfg.ema_decay > 0.0:
            if s.get("ema") is None:
                self.ema = self.fresh_ema()
                note = "lacked"
            else:
                self.ema = to(s["ema"])
        elif s.get("ema") is not None:
            note = "carried"
        return note


# ------------------------------------------------------------------- losses --

def make_microbatch_loss(cfg: TrainConfig, stem: int = 1,
                         lowres: bool = False,
                         deep_supervision: bool = False) -> Callable:
    """``(model, imgs, segs) -> (loss, aux)``: Dice + CE (+ region)
    (``make_segmentation_microbatch_loss`` :184-226). With ``lowres`` and
    stem > 1 the loss is scored on the pre-depth-to-space head output (same
    value, cheaper; train/loss.py), unless ``deep_supervision``: the aux
    heads' labels need the full-resolution form, which then scores the aux
    logits too (weights ``deep_supervision_weight``^depth)."""
    kw = dict(dice_weight=cfg.dice_weight, ce_weight=cfg.ce_weight,
              region_weight=cfg.region_weight)
    if lowres and stem > 1 and not deep_supervision:
        return lambda model, imgs, segs: segmentation_loss_lowres(
            model(imgs, subpixel=False), segs, stem, **kw)

    def loss(model, imgs, segs):
        out = model(imgs, deep_outputs=deep_supervision)
        logits, aux_logits = out if isinstance(out, tuple) else (out, None)
        return segmentation_loss(logits, segs, aux_logits=aux_logits,
                                 aux_weight=cfg.deep_supervision_weight, **kw)

    return loss


def train_update(model: torch.nn.Module, opt: Optimizer, loss_fn: Callable,
                 microbatches: Sequence[Tuple[torch.Tensor, torch.Tensor]]
                 ) -> Dict[str, torch.Tensor]:
    """Grads of each microbatch summed, divided by k, one optimizer
    update. Returns the mean aux (device tensors) plus ``grad_norm``."""
    bucket, aux_names, aux = shard_grads(model, loss_fn, microbatches,
                                         list(opt.params))
    return apply_update(opt, bucket, aux_names, aux)


def shard_grads(model: torch.nn.Module, loss_fn: Callable,
                microbatches: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                names: Sequence[str]):
    """The grads of ``microbatches`` summed and divided by k, as one flat
    f32 bucket in ``names`` order, and their mean aux stacked in the loss's
    order: (bucket, aux names, aux). The summed grads stay on the model."""
    k = len(microbatches)
    model.zero_grad(set_to_none=True)
    aux_sum: Dict[str, torch.Tensor] = {}
    for imgs, segs in microbatches:
        with profile.span("train.forward"):
            loss, aux = loss_fn(model, imgs, segs)
        with profile.span("train.backward"):
            loss.backward()
        for name, v in aux.items():
            v = v.detach().float()
            aux_sum[name] = v if name not in aux_sum else aux_sum[name] + v
    params = dict(model.named_parameters())
    bucket = torch.cat([
        (params[n].grad if params[n].grad is not None
         else torch.zeros_like(params[n])).float().reshape(-1) for n in names])
    aux_names = list(aux_sum)
    aux = torch.stack([aux_sum[a] for a in aux_names])
    if k > 1:
        bucket, aux = bucket / k, aux / k
    return bucket, aux_names, aux


def apply_update(opt: Optimizer, bucket: torch.Tensor,
                 aux_names: Sequence[str], aux: torch.Tensor
                 ) -> Dict[str, torch.Tensor]:
    """One optimizer update from a flat grad bucket (``shard_grads``'s
    order); returns the aux by name plus ``grad_norm``."""
    grads, off = {}, 0
    for n, p in opt.params.items():
        grads[n] = bucket[off:off + p.numel()].view(p.shape)
        off += p.numel()
    out = dict(zip(aux_names, aux.unbind(0)))
    with profile.span("train.update"):
        out["grad_norm"] = opt.step(grads)
    return out


# ----------------------------------------------------------------- sampling --

def step_generator(seed: int, micro: int, shard: int = 0) -> torch.Generator:
    """The host generator of one microbatch, from (seed, micro, shard)
    alone; shard 0's from (seed, micro), the one-device stream."""
    entropy = [seed, micro] if shard == 0 else [seed, micro, shard]
    state = np.random.SeedSequence(entropy).generate_state(1, np.uint64)
    return torch.Generator().manual_seed(int(state[0]))


def sample_microbatch(pool, cfg: TrainConfig, micro: int, shard: int = 0
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, *patch, 4) images and (B, *patch) int64 labels from the pool of
    global shard ``shard``."""
    gen = step_generator(cfg.seed, micro, shard)
    imgs, segs = [], []
    with profile.span("train.sample"):
        for _ in range(cfg.batch_per_device):
            ci = int(torch.randint(0, pool.image.shape[0], (), generator=gen))
            img, seg = sample_patch_impl(gen, pool.image[ci], pool.seg[ci],
                                         cfg.patch, pool.fg_host[ci], cfg.fg_prob)
            if cfg.augment:
                aug = draw_augment(gen, img.shape[-1], cfg.intensity_scale,
                                   cfg.intensity_shift, cfg.gamma_range)
                img, seg = apply_augment(img, seg, aug, rot90=cfg.rot90_axial)
            imgs.append(img)
            segs.append(seg)
        return torch.stack(imgs), torch.stack(segs).long()


class TrainStep:
    """``step(pool, i) -> aux``: sample k microbatches by the RNG contract,
    accumulate their grads, update the model in place. With a mesh of more
    than one shard (``env``), ``pool`` is the list of the local shards'
    pools and the step is data-parallel (module docstring)."""

    def __init__(self, model: torch.nn.Module, cfg: TrainConfig,
                 loss_fn: Callable, opt: Optional[Optimizer] = None,
                 env=None):
        self.model, self.cfg, self.loss_fn = model, cfg, loss_fn
        self.opt = opt or Optimizer(dict(model.named_parameters()), cfg)
        self.env = env if env is not None and env.n_data > 1 else None
        self._replicas: Dict[torch.device, torch.nn.Module] = {}
        if self.env is not None:
            home = next(model.parameters()).device
            for dev in self.env.local_devices():
                if dev != home:
                    self._replicas[dev] = copy.deepcopy(model).to(dev)

    def replica(self, dev: torch.device) -> torch.nn.Module:
        """The model on ``dev`` (the model itself on its own device)."""
        return self._replicas.get(dev, self.model)

    @torch.no_grad()
    def _sync_replicas(self) -> None:
        for rep in self._replicas.values():
            for p_r, p in zip(rep.parameters(), self.model.parameters()):
                p_r.copy_(p)

    @profile.entry
    def __call__(self, pool, step: int) -> Dict[str, torch.Tensor]:
        k = max(self.cfg.grad_accum_steps, 1)
        with profile.span("train.step", step):
            if self.env is None:
                batches = [sample_microbatch(pool, self.cfg, step * k + i)
                           for i in range(k)]
                return train_update(self.model, self.opt, self.loss_fn, batches)
            return self._dp_step(pool, step, k)

    def _dp_step(self, pools, step: int, k: int) -> Dict[str, torch.Tensor]:
        """The shards' buckets and aux averaged, then ``apply_update``."""
        from ..parallel.mesh import psum

        env = self.env
        if len(pools) != env.n_local:
            raise ValueError(f"{len(pools)} pools for {env.n_local} local shards")
        self._sync_replicas()
        names = list(self.opt.params)
        buckets, auxes, aux_names = [], [], None
        for j, dev in enumerate(env.devices):
            g = env.shard_index(j)
            batches = [sample_microbatch(pools[j], self.cfg, step * k + i, g)
                       for i in range(k)]
            bucket, aux_names, aux = shard_grads(self.replica(dev),
                                                 self.loss_fn, batches, names)
            buckets.append(bucket)
            auxes.append(aux)
        return apply_update(self.opt, psum(env, buckets) / env.n_data,
                            aux_names, psum(env, auxes) / env.n_data)


@torch.inference_mode()
def eval_labels(model: torch.nn.Module, image: torch.Tensor,
                device: torch.device) -> np.ndarray:
    """Whole-canvas forward of one (X, Y, Z, C) volume -> uint8 labels."""
    logits = model(image[None].to(device))[0]
    return torch.argmax(logits, dim=-1).to(torch.uint8).cpu().numpy()
