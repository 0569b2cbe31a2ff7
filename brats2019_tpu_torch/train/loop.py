"""Training loop, on one device or data-parallel over a mesh (reference:
``brats2019_tpu/train/loop.py``).

One :func:`train_stage` call trains one U-Net stage; the cascade is two
calls, coarse first (on the half-resolution view of each case, canvas
``max(m, (s // 2 // m) * m)`` per axis, :152-158) and fine. Sub-pixel nets
train on the low-resolution loss (:189-198). The host refreshes the case
pool, logs, validates on whole canvases and checkpoints, on the reference's
cadence and metric names; SIGTERM stops at the next step boundary with a
resumable checkpoint.

The training left-outs of the reference's loop (:62-76, :104-124, :127-271):
distillation (``kd_teachers``, ``train/distill.py``), warm start
(``init_from``: exported params or a foreign torch checkpoint, a resumable
checkpoint winning), deep supervision (the full-resolution loss with the
aux heads), the prep cache and ``--debug-checks`` (``TrainConfig``),
``debug_nans`` and a ``torch.profiler`` trace of steps 10-20 (``profile``).

Data parallelism (``env``, a ``parallel/mesh.py`` mesh of more than one
shard; :133-148, :333, :346, :412): a pool per local shard, the
data-parallel step of ``train/step.py``, validation striped over the shards
(canvas i on global shard i mod n, the labels all-gathered so every process
scores every canvas, as ``make_batched_eval_step``), throughput counted as
``batch_per_device * n_data`` patches a step. The first process alone writes
logs and checkpoints (each shard's cursor in ``cursor["shards"]``); a stop
signal on any process stops all of them at the same step. One shard is the
one-device loop.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..configs.presets import ExperimentConfig, TrainConfig, UNetConfig
from ..data.case import load_case
from ..data.pipeline import CasePool, prepare_training_case
from ..infer.predictor import resolve_device
from ..models.unet3d import UNet3D
from ..utils.flops import mfu as _mfu, train_step_flops
from ..utils.logging import MetricsLogger
from ..utils.profile import start_trace, stop_trace
from ..utils.weights import (flat_from_state_dict, import_params, init_params,
                             require_unet, state_dict_from_flat)
from .checkpoint import CheckpointManager
from .metrics import region_dice_np
from .step import Optimizer, TrainStep, eval_labels, make_microbatch_loss


@dataclasses.dataclass
class StageResult:
    model: torch.nn.Module
    final_metrics: Dict[str, float]
    workdir: str
    # stopped early on SIGTERM: a resumable checkpoint was saved and later
    # stages must not start
    preempted: bool = False


def stage_config(exp: ExperimentConfig, stage: str):
    """(unet config, train config, downsample) of a stage: the coarse
    stage trains on 64^3 patches of the half-resolution canvas."""
    cfg = exp.train
    unet_cfg = exp.unet if stage == "fine" else exp.coarse_unet
    if unet_cfg is None:
        raise ValueError(f"no unet config for stage '{stage}'")
    require_unet(unet_cfg, "training")
    if stage == "coarse":
        m = unet_cfg.min_spatial
        canvas = tuple(max(m, (s // 2 // m) * m) for s in cfg.pool_shape)
        cfg = dataclasses.replace(cfg, patch=cfg.coarse_patch, pool_shape=canvas)
        return unet_cfg, cfg, 2
    return unet_cfg, cfg, cfg.train_downsample


def init_stage(unet_cfg: UNetConfig, train_cfg: TrainConfig,
               device: torch.device):
    """Model (seeded random init, train mode; with the aux heads under deep
    supervision) and its optimizer."""
    model = UNet3D(unet_cfg)
    model.load_state_dict(state_dict_from_flat(
        init_params(unet_cfg, train_cfg.seed)))
    model = model.to(device).train()
    return model, Optimizer(dict(model.named_parameters()), train_cfg)


def _load_init_params(path: str, like: Dict[str, np.ndarray]
                      ) -> Dict[str, np.ndarray]:
    """Warm-start source by extension: exported flat params (npz /
    safetensors) or a reference torch state dict (pt/pth, through
    ``utils/torch_import.py``); shapes are validated against ``like`` (the
    stage's flat params) either way."""
    if path.endswith((".pt", ".pth")):
        from ..utils.torch_import import import_torch_params, load_torch_state

        loaded, notes = import_torch_params(load_torch_state(path), like)
        for n in notes:
            print(f"[init-from] note: {n}", flush=True)
        return loaded
    return import_params(path, like)


def _validate_pool_sampling(pool: CasePool, cfg: TrainConfig) -> None:
    """``--debug-checks`` start-up check: the sampler's bounds checks on
    every pool slot's foreground table and one sampled patch (fg path
    forced), so a mis-built pool fails before step 0 instead of clamping.
    Runs once; adds nothing to a step."""
    from ..data.sampling import checked_sample_batch

    gen = torch.Generator().manual_seed(0)
    for slot in range(pool.k):
        checked_sample_batch(gen, pool.image[slot], pool.seg[slot],
                             tuple(cfg.patch), batch=1,
                             fg_table=pool.fg_host[slot], fg_prob=1.0)


def _val_labels(step_fn, env, val_canvases, device) -> List[np.ndarray]:
    """Each validation canvas's labels: on ``device`` by the model, or with
    a data-parallel ``env`` canvas i on global shard i mod n_data by that
    shard's replica, the labels gathered on every process."""
    if env is None:
        return [eval_labels(step_fn.model, c["image"], device)
                for c in val_canvases]
    from ..parallel.mesh import all_gather_objects

    mine = {}
    for j, dev in enumerate(env.devices):
        g = env.shard_index(j)
        for i in range(g, len(val_canvases), env.n_data):
            mine[i] = eval_labels(step_fn.replica(dev),
                                  val_canvases[i]["image"], dev)
    labels = {}
    for part in all_gather_objects(env, mine):
        labels.update(part)
    return [labels[i] for i in range(len(val_canvases))]


def _validate(labels: List[np.ndarray],
              val_canvases: List[Dict[str, object]]) -> Dict[str, float]:
    dices = {"WT": [], "TC": [], "ET": []}
    for lab, c in zip(labels, val_canvases):
        d = region_dice_np(lab, c["seg"])
        for k in dices:
            dices[k].append(d[k])
    out = {f"dice_{k}": float(np.mean(v)) for k, v in dices.items()}
    out["dice_mean"] = float(np.mean([out[f"dice_{k}"] for k in dices]))
    return out


class _Pools:
    """The local shards' pools of a data-parallel run, with the one pool's
    interface the loop uses (refresh, start/stop, cursor state)."""

    def __init__(self, env, case_dirs, canvas, cases, downsample, seed,
                 prep_cache_dir):
        self.env = env
        self.pools = [CasePool(case_dirs, dev, canvas=canvas, cases=cases,
                               downsample=downsample, seed=seed,
                               prep_cache_dir=prep_cache_dir,
                               stride=env.n_data, offset=env.shard_index(j))
                      for j, dev in enumerate(env.devices)]

    def start(self) -> None:
        for p in self.pools:
            p.start()

    def stop(self) -> None:
        for p in self.pools:
            p.stop()

    def maybe_refresh(self) -> None:
        for p in self.pools:
            p.maybe_refresh()

    def state(self) -> Dict[str, object]:
        """Every global shard's cursor, in shard order (collective)."""
        from ..parallel.mesh import all_gather_objects

        states = [s for part in all_gather_objects(
            self.env, [p.state() for p in self.pools]) for s in part]
        return {"shards": states}

    def load_state(self, s) -> None:
        shards = s.get("shards") if isinstance(s, dict) else None
        for j, p in enumerate(self.pools):
            g = self.env.shard_index(j)
            if shards is not None and g < len(shards):
                p.load_state(shards[g])
            elif shards is None and g == 0:
                p.load_state(s)


class _NullLogger:
    def log(self, *args, **kwargs) -> None:
        pass

    def close(self) -> None:
        pass


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_stage(
    exp: ExperimentConfig,
    case_dirs: Sequence[str],
    *,
    stage: str = "fine",
    val_dirs: Sequence[str] = (),
    device="cuda",
    profile: bool = False,
    kd_teachers: Optional[Sequence[torch.nn.Module]] = None,
    kd_config=None,
    init_from: Optional[str] = None,
    debug_nans: bool = False,
    env=None,
) -> StageResult:
    """Train one stage to ``exp.train.steps`` (resuming from the latest
    checkpoint of its workdir). Runs on the card unless the caller asks for
    ``device="cpu"``; a CUDA request without a card raises.

    ``kd_teachers``: frozen ``UNet3D`` teachers on ``device``: the stage
    trains as their KD student (``kd_config``, default ``KDConfig()``); over
    a mesh, each distinct local device gets its own frozen replicas
    (``distill.teacher_replicas``).
    ``init_from``: warm-start the params from ``params.{npz,safetensors}``
    or a torch checkpoint ``.pt/.pth``, with a fresh optimizer (its EMA
    seeded from the loaded weights) at step 0; a resumable checkpoint in
    the workdir always wins. ``debug_nans``: stop with FloatingPointError at
    the first step whose loss or gradient norm is not finite (a host read
    of both each step; none without it). ``profile``: a torch.profiler
    trace of steps 10-20 of this run in ``<workdir>/<stage>/profile``.
    ``env``: a ``parallel/mesh.py`` mesh; more than one shard trains
    data-parallel on its devices (module docstring), ``device`` unused."""
    from ..parallel import mesh as meshlib

    dp = env is not None and env.n_data > 1
    device = env.first if env is not None else resolve_device(device)
    lead = env is None or env.rank == 0
    unet_cfg, cfg, downsample = stage_config(exp, stage)
    workdir = os.path.join(exp.workdir, stage)
    os.makedirs(workdir, exist_ok=True)

    model, opt = init_stage(unet_cfg, cfg, device)
    ckpt = CheckpointManager(workdir, keep=cfg.keep_checkpoints)
    logger = MetricsLogger(workdir, name=f"{stage}") if lead else _NullLogger()
    if dp:
        pool = _Pools(env, case_dirs, cfg.pool_shape,
                      cfg.pool_cases_per_device, downsample, cfg.seed,
                      cfg.prep_cache_dir)
    else:
        pool = CasePool(case_dirs, device, canvas=cfg.pool_shape,
                        cases=cfg.pool_cases_per_device, downsample=downsample,
                        seed=cfg.seed, prep_cache_dir=cfg.prep_cache_dir)
    if cfg.debug_checks:
        for p in (pool.pools if dp else [pool]):
            _validate_pool_sampling(p, cfg)
        print(f"[{stage}] --debug-checks: pool sampling bounds OK", flush=True)

    start_step = 0
    restored = ckpt.restore()
    if restored is not None:
        model.load_state_dict(state_dict_from_flat(
            {k: v.numpy() for k, v in restored["params"].items()}))
        note = opt.load_state_dict(restored["opt_state"])
        if note:
            print(f"[{stage}] note: checkpoint optimizer state {note} a weight "
                  f"EMA; migrated to match ema_decay={cfg.ema_decay}", flush=True)
        start_step = restored["step"]
        pool.load_state(restored["cursor"])
        print(f"[{stage}] resumed from step {start_step}", flush=True)
        if init_from:
            print(f"[{stage}] note: --init-from {init_from} IGNORED — a "
                  "resumable checkpoint exists and continuing it wins",
                  flush=True)
    elif init_from:
        like = flat_from_state_dict(model.state_dict())
        model.load_state_dict(state_dict_from_flat(
            _load_init_params(init_from, like)))
        # a fresh optimizer AFTER the swap: its EMA starts from the loaded
        # weights, not from the discarded random init
        opt = Optimizer(dict(model.named_parameters()), cfg)
        print(f"[{stage}] warm-started params from {init_from} "
              "(fresh optimizer state, step 0)", flush=True)

    if kd_teachers:
        from .distill import KDConfig, make_kd_microbatch_loss, teacher_replicas

        # over shards: each local device's shards run its own replicas
        teachers = teacher_replicas(
            kd_teachers, env.local_devices() if dp else [device])
        loss_fn = make_kd_microbatch_loss(teachers, cfg,
                                          kd_config or KDConfig(),
                                          unet_cfg.deep_supervision)
    else:
        loss_fn = make_microbatch_loss(
            cfg, unet_cfg.stem_downsample, lowres=unet_cfg.stem_downsample > 1,
            deep_supervision=unet_cfg.deep_supervision)
    step_fn = TrainStep(model, cfg, loss_fn, opt, env=env)

    val_canvases = []
    for d in val_dirs:
        c = prepare_training_case(load_case(d, load_seg=True), cfg.pool_shape,
                                  downsample=downsample)
        val_canvases.append({"image": c["image"], "seg": c["seg"]})

    if cfg.pool_refresh_every:
        pool.start()
    step_flops = train_step_flops(unet_cfg, cfg)
    n_data = env.n_data if env is not None else 1
    if env is not None:
        # the flops one device runs a step: its shards' share
        step_flops *= env.n_local / len(env.local_devices())
    device_name = (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu")
    t_last = time.time()
    steps_since_log = 0
    last_metrics: Dict[str, float] = {}
    preempt = {"sig": None}
    prev_handler = None
    try:
        prev_handler = signal.signal(
            signal.SIGTERM, lambda s, f: preempt.__setitem__("sig", s))
    except ValueError:  # not the main thread: no handler
        pass

    def stop_requested() -> bool:
        if env is None or not env.multiprocess:
            return preempt["sig"] is not None
        # every process stops at the same step, whichever got the signal
        flag = torch.tensor([0.0 if preempt["sig"] is None else 1.0],
                            device=device)
        return bool(meshlib.all_reduce_(env, flag).item() > 0)

    def save(step_no: int) -> None:
        state = pool.state()        # collective on a data-parallel run
        if lead:
            ckpt.save(step_no, model, opt.state_dict(), state)
    preempted = False
    prof = None
    try:
        for step in range(start_step, cfg.steps):
            if profile and step == start_step + 10:
                prof = start_trace(device)
            if prof is not None and step == start_step + 20:
                stop_trace(prof, device, os.path.join(workdir, "profile"))
                prof = None
            aux = step_fn(pool.pools if dp else pool, step)
            if debug_nans and not (bool(torch.isfinite(aux["loss"]))
                                   and bool(torch.isfinite(aux["grad_norm"]))):
                raise FloatingPointError(
                    f"[{stage}] --debug-nans: step {step + 1} gave loss "
                    f"{float(aux['loss'])}, grad_norm {float(aux['grad_norm'])}")
            steps_since_log += 1
            if cfg.pool_refresh_every and step % cfg.pool_refresh_every == 0:
                pool.maybe_refresh()

            if (cfg.log_every and (step + 1) % cfg.log_every == 0
                    or step == cfg.steps - 1):
                last_metrics = {k: float(v) for k, v in aux.items()}
                _sync(device)
                dt = time.time() - t_last
                sps = steps_since_log / max(dt, 1e-9)
                last_metrics["steps_per_sec"] = sps
                last_metrics["patches_per_sec"] = (sps * cfg.batch_per_device
                                                   * n_data)
                m = _mfu(step_flops, 1.0 / max(sps, 1e-9), device_name)
                if m is not None:
                    last_metrics["mfu"] = m
                logger.log(step + 1, last_metrics)
                t_last = time.time()
                steps_since_log = 0

            if cfg.eval_every and (step + 1) % cfg.eval_every == 0 and val_canvases:
                vm = _validate(_val_labels(step_fn, env if dp else None,
                                           val_canvases, device), val_canvases)
                logger.log(step + 1, vm, prefix="val_")
                if lead:
                    ckpt.maybe_save_best(step + 1, model, vm["dice_mean"])
            saved_now = bool(cfg.checkpoint_every) and (
                (step + 1) % cfg.checkpoint_every == 0 or step == cfg.steps - 1)
            if saved_now:
                save(step + 1)
            if stop_requested():
                if not saved_now:
                    save(step + 1)
                preempted = True
                print(f"[{stage}] SIGTERM at step {step + 1}: checkpoint saved, "
                      "stopping gracefully (resume continues here)", flush=True)
                break
    finally:
        if prev_handler is not None:
            try:
                signal.signal(signal.SIGTERM, prev_handler)
            except ValueError:
                pass
        if prof is not None:
            # a run shorter than start + 20 steps still writes its trace
            stop_trace(prof, device, os.path.join(workdir, "profile"))
        pool.stop()
        logger.close()

    # final checkpoint of a short run that never hit checkpoint_every (not
    # after preemption: that save recorded the true step)
    if not preempted and start_step < cfg.steps and (
        cfg.checkpoint_every == 0 or cfg.steps < cfg.checkpoint_every
    ):
        save(cfg.steps)
    if env is not None:
        meshlib.barrier(env)    # every checkpoint written before any resume
    return StageResult(model=model, final_metrics=last_metrics,
                       workdir=workdir, preempted=preempted)
