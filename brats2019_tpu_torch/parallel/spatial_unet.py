"""Whole-volume U-Net forward and training gradients with the volume's X
axis split over the mesh (reference: ``brats2019_tpu/parallel/spatial_unet
.py``): the context-parallel form of this CNN.

Every op of ``models/unet3d.py`` is made exact on a shard of the volume:

  conv3x3x3      1-plane halo (zeros at the volume's edges), the conv kernel
                 on the padded shard, the halo rows dropped
  InstanceNorm   each shard's statistics pass alone (the IN kernel's first
                 pass, ``ops.instance_norm_partials``), every shard's
                 partials gathered in shard order and merged by the IN
                 kernel's merge-apply on each shard: statistics over the
                 whole volume (:43-61). Taken after the crop, so the halo
                 planes never enter them (the conv's STATS epilogue would
                 count them)
  avg-pool 2x    local (the shard stays even at every level)
  trilinear 2x   1-plane halo, with the edge plane repeated at the volume's
                 edges: the global resize's replicate clamp, so the boundary
                 shards' outer planes come out as the unsharded up's
                 (:70-87); the up written straight into the concat buffer
                 (``ops.upsample2x_concat``, the skip padded to match), the
                 halo's rows dropped
  s2d / d2s, head, skip concat   local

The backward of the InstanceNorm over shards: each shard's IN backward
kernel gives dx with its own shard's sums of g_a and g_a * x-hat; the
volume's sums are the shards' summed (``mesh.psum``), and dx gains
gamma * rstd * ((A_j - A) + x-hat (B_j - B)) with A, B the volume's means
and A_j, B_j the shard's. dgamma and dbeta are the local shards' sums, so
after the processes' all-reduce every parameter's gradient is the whole
volume's.

The forward takes the port's ``UNet3D`` (its parameters, their names and
the weight bridge unchanged); the weights stay on the model's device and
move to each shard's device inside the graph, so the gradient comes back to
the one model. Constraint: the volume's X divides by stem * 2^(levels-1) *
shards (``UNetConfig.min_spatial`` * ``n_data``).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import torch

from ..models.unet3d import UNet3D, depth_to_space, space_to_depth
from ..ops import (conv3d, downsample2x, instance_norm_partials,
                   upsample2x_concat)
from ..ops.norm import _affine, instance_norm_act_bwd, instance_norm_act_fwd
from .mesh import MeshEnv, all_reduce_, gather_shards, psum
from .spatial import gather_x, halo_exchange, split_x


def _on(t: torch.Tensor, dev: torch.device, cache: Dict) -> torch.Tensor:
    if dev not in cache:
        cache[dev] = t.to(dev)
    return cache[dev]


class _ShardedInstanceNormAct(torch.autograd.Function):
    """IN + activation over the shards of one volume (N = 1 a shard), with
    the volume's statistics; see the module docstring for the backward."""

    @staticmethod
    def forward(ctx, env, activation, eps, scale, bias, *ys):
        parts = [instance_norm_partials(y) for y in ys]
        every = torch.cat(gather_shards(env, parts), dim=2)
        p_on, s_on, b_on = {}, {}, {}
        outs, saved = [], []
        for y in ys:
            dev = y.device
            out, mean, rstd = instance_norm_act_fwd(
                y, _on(scale, dev, s_on), _on(bias, dev, b_on), eps,
                activation, _on(every, dev, p_on))
            gamma, beta = _affine(y, _on(scale, dev, s_on), _on(bias, dev, b_on))
            outs.append(out)
            saved += [y, gamma, beta, mean, rstd]
        ctx.save_for_backward(*saved)
        ctx.env, ctx.activation = env, activation
        ctx.devs = (scale.device, bias.device)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        env = ctx.env
        saved = ctx.saved_tensors
        dxs, dgams, dbets, terms = [], [], [], []
        for j, g in enumerate(gs):
            y, gamma, beta, mean, rstd = saved[5 * j:5 * j + 5]
            if y.shape[0] != 1:
                raise ValueError("the sharded InstanceNorm takes one volume "
                                 f"(N = 1) a shard, got N = {y.shape[0]}")
            dx, dgam, dbet = instance_norm_act_bwd(
                y, g.contiguous(), gamma, beta, mean, rstd, ctx.activation)
            dxs.append(dx)
            dgams.append(dgam)
            dbets.append(dbet)
            terms.append((y, gamma, mean, rstd))
        if env.n_data > 1:
            count = float(terms[0][0][0, ..., 0].numel())
            a_all = psum(env, dbets) / (count * env.n_data)
            b_all = psum(env, dgams) / (count * env.n_data)
            a_on, b_on = {}, {}
            for j, (y, gamma, mean, rstd) in enumerate(terms):
                dev = y.device
                xhat = (y.float() - mean) * rstd
                corr = (gamma * rstd) * ((dbets[j] / count - _on(a_all, dev, a_on))
                                         + xhat * (dgams[j] / count
                                                   - _on(b_all, dev, b_on)))
                dxs[j] = (dxs[j].float() + corr).to(y.dtype)
        d_scale = sum(d.to(ctx.devs[0]) for d in dgams)
        d_bias = sum(d.to(ctx.devs[1]) for d in dbets)
        return (None, None, None, d_scale, d_bias, *dxs)


def _conv_weight(conv) -> torch.Tensor:
    """A ``Conv3x3``'s kernel in its compute dtype, inside the graph when it
    takes a gradient (as ``Conv3x3.forward``)."""
    if torch.is_grad_enabled() and conv.kernel.requires_grad:
        return conv.kernel.to(conv.compute_dtype)
    return conv.cached_kernel()


def _conv_halo(env: MeshEnv, xs: Sequence[torch.Tensor], conv) -> List[torch.Tensor]:
    """SAME conv of NDHWC shards split on D: 1-plane halos, the conv on the
    padded shard (the kernel, without the STATS epilogue: it would count
    the halo planes), the halo rows dropped."""
    w = _conv_weight(conv)
    w_on: Dict = {}
    padded = halo_exchange(env, xs, 1, axis=1)
    return [conv3d(xp.to(conv.compute_dtype), _on(w, xp.device, w_on))
            .narrow(1, 1, x.shape[1]) for xp, x in zip(padded, xs)]


def _double_conv(env: MeshEnv, xs, block, activation: str):
    for name in ("ConvNormAct_0", "ConvNormAct_1"):
        cna = getattr(block, name)
        ys = _conv_halo(env, xs, cna.Conv_0)
        xs = list(_ShardedInstanceNormAct.apply(
            env, activation, 1e-5, cna.in_scale, cna.in_bias, *ys))
    return xs


def _up_concat_halo(env: MeshEnv, xs, skips, dtype) -> List[torch.Tensor]:
    """2x trilinear up of each shard, seam-exact: a 1-plane halo (the edge
    plane repeated at the volume's edges: the replicate clamp of the
    unsharded up), the up written into the concat buffer beside the skip
    (padded by the halo's two up planes a side), the halo's rows dropped."""
    padded = halo_exchange(env, xs, 1, axis=1, edge="replicate")
    outs = []
    for xp, sk in zip(padded, skips):
        sk = sk.to(dtype)
        pad = sk.new_zeros((sk.shape[0], 2) + tuple(sk.shape[2:]))
        buf = upsample2x_concat(xp, torch.cat([pad, sk, pad], 1))
        outs.append(buf.narrow(1, 2, sk.shape[1]))
    return outs


def _head(model: UNet3D, x: torch.Tensor) -> torch.Tensor:
    head = model.head
    k = head.kernel.reshape(head.kernel.shape[3], head.kernel.shape[4])
    return (torch.matmul(x.float(), k.float().to(x.device))
            + head.bias.float().to(x.device))


def spatial_unet_forward(model: UNet3D, env: MeshEnv,
                         shards: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Shard-local ``UNet3D`` forward on (1, X_l, Y, Z, C) shards of one
    volume split on X over ``env`` (:90-144); returns the local logits
    (1, X_l, Y, Z, K), f32. The model's parameters, as trained."""
    cfg = model.config
    dt = cfg.dtype
    r = cfg.stem_downsample
    xs = [s.to(dt) for s in shards]
    if r > 1:
        xs = [space_to_depth(x, r) for x in xs]
    i = 0
    skips = []
    for lvl in range(cfg.levels):
        xs = _double_conv(env, xs, getattr(model, f"DoubleConv_{i}"),
                          cfg.activation)
        i += 1
        if lvl < cfg.levels - 1:
            skips.append(xs)
            xs = [downsample2x(x) for x in xs]
    for lvl in reversed(range(cfg.levels - 1)):
        xs = _up_concat_halo(env, xs, skips[lvl], dt)
        xs = _double_conv(env, xs, getattr(model, f"DoubleConv_{i}"),
                          cfg.activation)
        i += 1
    logits = [_head(model, x) for x in xs]
    if r > 1:
        logits = [depth_to_space(lg, r) for lg in logits]
    return logits


def _check_extent(env: MeshEnv, model: UNet3D, x_extent: int) -> None:
    req = model.config.min_spatial * env.n_data
    if x_extent % req:
        raise ValueError(
            f"spatial sharding needs X ({x_extent}) divisible by "
            f"stem*2^(levels-1)*shards = {req}")


def make_spatial_unet(env: MeshEnv, model: UNet3D) -> Callable:
    """``fn(x (X, Y, Z, C)) -> logits (X, Y, Z, K)`` f32: the volume split
    on X over the mesh, the logits gathered on the first shard's device of
    every process (:178-192)."""

    def fn(x: torch.Tensor) -> torch.Tensor:
        _check_extent(env, model, x.shape[0])
        with torch.inference_mode():
            out = spatial_unet_forward(model, env, split_x(env, x[None], 1))
            return gather_x(env, [o[0] for o in out])

    return fn


def make_spatial_train_grad(env: MeshEnv, model: UNet3D) -> Callable:
    """Whole-volume training gradients with the volume split on X
    (:147-175): ``fn(x (X, Y, Z, C), labels (X, Y, Z) int) -> (loss, grads
    {parameter name: gradient})``. Each shard's loss is the mean voxel
    cross-entropy of its logits; the volume's loss is their mean, and its
    gradient, through the halos and the volume's IN statistics, is the
    unsharded model's. The gradients are summed over the processes (each
    process's are its shards' share)."""

    def fn(x: torch.Tensor, labels: torch.Tensor
           ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        _check_extent(env, model, x.shape[0])
        model.zero_grad(set_to_none=True)
        logits = spatial_unet_forward(model, env, split_x(env, x[None], 1))
        losses = []
        for lg, y in zip(logits, split_x(env, labels[None], 1)):
            logp = torch.log_softmax(lg.float(), dim=-1)
            picked = logp.gather(-1, y.long().unsqueeze(-1))
            losses.append(-picked.mean())
        first = env.first
        total = sum(l.to(first) for l in losses) / env.n_data
        total.backward()
        grads = {}
        for name, p in model.named_parameters():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            grads[name] = all_reduce_(env, g.detach().clone())
        loss = psum(env, [l.detach() for l in losses]) / env.n_data
        return loss, grads

    return fn
