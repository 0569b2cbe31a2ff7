"""Traffic kind ``train``: a trainer fills the card.

``TrainStep`` steps at the mix's ``batch_per_device`` on a pool of
``pool_cases`` synthetic cases (from the seed), the configuration's
``TrainConfig`` otherwise. It trains the U-Net and refuses a configuration
that names another network. Set-up builds the one step object the window
drives and runs its first ``checked_steps`` steps, which the plain reference
follows; the window counts patches over its wall time to a final
synchronise. The traced run times ``trace_timed_steps`` steps by CUDA events
and profiles ``trace_profiled_steps`` more.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict

import torch

from perfbench import synth, trace, yardstick
from perfbench.drivers import (Context, Outcome, device_seconds, free, peak_bytes,
                               sync)
from perfbench.reference import networks, train as ref_train, unet as ref_unet


def _train_config(ctx: Context) -> dict:
    t = dict(ctx.config["train"])
    t.update(batch_per_device=ctx.mix["batch_per_device"],
             pool_cases_per_device=ctx.mix["pool_cases"], seed=int(ctx.seed))
    return t


def setup(ctx: Context):
    """(step, pool, initial weights on the host, the program's readings of
    its first ``checked_steps`` steps)."""
    from brats2019_tpu_torch.models.unet3d import UNet3D
    from brats2019_tpu_torch.train.step import (Optimizer, TrainStep,
                                                make_microbatch_loss)

    dev, cfg = ctx.device, ctx.config
    if networks.section(cfg) != networks.DEFAULT:
        raise ValueError(f"the train driver trains the U-Net only, not {networks.section(cfg)}")
    tdict = _train_config(ctx)
    tcfg = dataclasses.replace(ctx.exp.train, **{
        k: tdict[k] for k in ("batch_per_device", "pool_cases_per_device", "seed")})
    pool = synth.training_pool(tcfg.pool_cases_per_device, ctx.mix["raw_shape"],
                               tcfg.pool_shape, ctx.seed, dev)
    made = synth.params(ref_unet.param_shapes(cfg["unet"]), ctx.seed, "fine", dev)
    p0 = {k: v.cpu().numpy() for k, v in made.items()}
    net = ctx.exp.unet
    model = UNet3D(net)
    model.load_state_dict({k[len("params/"):].replace("/", "."): v
                           for k, v in made.items()}, strict=True)
    del made
    model = model.to(dev).train()
    free(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    opt = Optimizer(dict(model.named_parameters()), tcfg)
    loss_fn = make_microbatch_loss(tcfg, net.stem_downsample,
                                   lowres=net.stem_downsample > 1,
                                   deep_supervision=net.deep_supervision)
    step = TrainStep(model, tcfg, loss_fn, opt)
    flat = lambda name: "params/" + name.replace(".", "/")
    losses, grad, grad_t = [], None, None
    for i in range(ctx.mix["checked_steps"]):
        losses.append(step(pool, i)["loss"])
        if i == 0:   # the first gradient as the optimizer took it: mu / (1 - b1)
            grad_t = {flat(k): v.detach().cpu() / (1 - opt.B1) for k, v in opt.mu.items()}
            grad = {k: float(v.double().norm()) for k, v in grad_t.items()}
    delta = {flat(k): float((p.detach().cpu().double() - torch.from_numpy(p0[flat(k)])
                             .double()).norm())
             for k, p in model.named_parameters()}
    got = {"losses": [float(x) for x in losses], "grad": grad, "grad_t": grad_t,
           "delta": delta}
    sync(dev)
    return step, pool, p0, tdict, got


def compare(ctx: Context, pool, p0, tdict, got, **kw) -> Dict[str, float]:
    ref = ref_train.run_steps(p0, ctx.config["unet"], tdict, pool, ctx.seed,
                              steps=ctx.mix["checked_steps"], device=ctx.device, **kw)
    return ref_train.compare(got, ref)


def run(ctx: Context) -> Outcome:
    dev, mix = ctx.device, ctx.mix
    step, pool, p0, tdict, got = setup(ctx)
    setup_s = time.perf_counter() - ctx.t0
    i0 = mix["checked_steps"]
    losses: list = []

    def steps(n_or_seconds, by_time=False):
        nonlocal i0
        t, n = time.perf_counter(), 0
        while (time.perf_counter() - t < n_or_seconds) if by_time else n < n_or_seconds:
            losses.append(step(pool, i0)["loss"])
            i0, n = i0 + 1, n + 1
        return n

    e2e, readings, prof = {"setup_s": setup_s}, {"kind": "train"}, None
    if not ctx.traced:
        t = time.perf_counter()
        done = steps(ctx.seconds, by_time=True)
        sync(dev)
        e2e["train_patches_per_s"] = done * tdict["batch_per_device"] / (
            time.perf_counter() - t)
    else:
        n = mix["trace_timed_steps"]
        step_s = device_seconds(dev, lambda: steps(n)) / n
        done, prof = trace.profiled(lambda: steps(mix["trace_profiled_steps"]),
                                    lambda: sync(dev))
        done += n
        readings.update(train_step_s=step_s, step_flops=yardstick.train_step_flops(
            ctx.config["unet"], tdict))
    failed = sum(1 for x in losses if not bool(torch.isfinite(x)))
    peak = peak_bytes(dev)
    del step, losses
    free(dev)
    checks = compare(ctx, pool, p0, tdict, got)
    return Outcome(done, failed, e2e, readings, prof, checks, peak)
