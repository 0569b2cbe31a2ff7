#!/usr/bin/env python3
"""Batch 2 against two batch-1 runs on a CUDA card: are the data-parallel
step's averaged gradients (two shards of batch 1) the one-shard step's on
the concatenated batch of 2?

    timeout 600 python3 tools/torch_dp_check.py

Holds the backward kernels at batch 2 at the flagship fine step's shapes
against their plain versions and against the same kernel run per sample
(the IN+act backward's dx, dgamma, dbeta; the 2x up backward read from a
concat gradient; the 2x down backward), then the fine net at full width
(random init, bf16): per parameter max|d|/max|ref| of the batch-2 grads
against the mean of the two batch-1 grads at 64^3 and 128^3 patches, and
at 64^3 the same on the plain path on the CPU (bf16), and card against CPU;
then all of that at an f32 compute dtype, as the relative L2 distance of
all grads.

    timeout 900 python3 tools/torch_dp_check.py --f64

instead measures how far the card's f32 grads lie from exact ones: the fine
net at full width (random init) runs its f32 step on the card, and in f64
on the CPU's plain path (every op of the plain path computed in f64, see
:func:`float64_plain`). Per patch (64^3, 128^3): the f64 batch-2 grads
against the mean of the two f64 batch-1 runs (separability: the loss is a
mean over samples), and the card's f32 batch-2 grads and the mean of its two
batch-1 runs, each against the f64 batch-2 grads; then, on one 64^3 volume
with the voxel-mean cross-entropy, the card's unsharded f32 grads and
``make_spatial_train_grad``'s over 2 shards of the card, against f64. All as
relative L2 over every parameter. The sum of two runs' distances from f64
bounds their distance from each other: ``chip_smoke.py`` phase 9's f32
tolerances are set from these sums.
Prints the numbers; checks nothing (``chip_smoke.py`` phase 9 holds the
step in f32).
"""
import contextlib
import copy
import os
import sys

sys.path.insert(0, ".")
import torch  # noqa: E402

from brats2019_tpu_torch.configs.presets import get_preset  # noqa: E402
from brats2019_tpu_torch.ops import norm, resize  # noqa: E402
from brats2019_tpu_torch.train.loop import init_stage, stage_config  # noqa: E402
from brats2019_tpu_torch.train.step import make_microbatch_loss  # noqa: E402


def rel(a, b):
    """max|a - b| / max|b|."""
    return ((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-30)).item()


def main() -> int:
    if not torch.cuda.is_available():
        print("error: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    if "--f64" in sys.argv[1:]:
        return f64_main(dev)
    g = torch.Generator(device=dev).manual_seed(1)

    print("== IN backward, N=2 kernel vs per-sample kernel vs plain")
    for shape in [(2, 64, 64, 64, 64), (2, 32, 32, 32, 128), (2, 16, 16, 16, 256), (2, 8, 8, 8, 320),
                  (2, 64, 64, 64, 128), (2, 32, 32, 32, 256)]:
        x = torch.randn(shape, generator=g, device=dev).bfloat16()
        gy = torch.randn(shape, generator=g, device=dev).bfloat16()
        c = shape[-1]
        gam = torch.rand(c, generator=g, device=dev) + 0.5
        bet = torch.randn(c, generator=g, device=dev) * 0.1
        _, mean, rstd = norm._plain_stats(x, gam, bet, 1e-5, "relu")
        dx, dg, db = norm.instance_norm_act_bwd(x, gy, gam, bet, mean, rstd, "relu")
        pdx, pdg, pdb = norm.instance_norm_act_bwd_plain(x, gy, gam, bet, mean, rstd, "relu")
        per = [norm.instance_norm_act_bwd(x[i:i+1].contiguous(), gy[i:i+1].contiguous(), gam, bet,
                                          mean[i:i+1].contiguous(), rstd[i:i+1].contiguous(), "relu") for i in range(2)]
        sdx = torch.cat([p[0] for p in per]); sdg = per[0][1] + per[1][1]; sdb = per[0][2] + per[1][2]
        plan = norm.plan_in_bwd(shape[0], shape[1]*shape[2]*shape[3], c, dtype=torch.bfloat16)
        plan1 = norm.plan_in_bwd(1, shape[1]*shape[2]*shape[3], c, dtype=torch.bfloat16)
        print(shape, "plan N2", plan, "plan N1", plan1)
        print("   dx kernelN2 vs plain", rel(dx, pdx), "kernelN1 vs plain", rel(sdx, pdx),
              "dgamma N2", rel(dg, pdg), "N1", rel(sdg, pdg), "dbeta N2", rel(db, pdb), "N1", rel(sdb, pdb), flush=True)

    print("== up backward and down backward at N=2")
    for (n, d, c, cs) in [(2, 32, 64, 64), (2, 16, 128, 128), (2, 8, 256, 256), (2, 4, 320, 320)]:
        gcat = torch.randn((n, 2*d, 2*d, 2*d, c + cs), generator=g, device=dev).bfloat16()
        gu = gcat[..., :c]
        got = resize.upsample2x_bwd(gu)
        ref = resize.upsample2x_bwd_plain(gu.contiguous())
        per = torch.cat([resize.upsample2x_bwd(gcat[i:i+1][..., :c]) for i in range(n)])
        print("up bwd", (n, d, c), "N2 vs plain", rel(got, ref), "N1 vs plain", rel(per, ref), flush=True)
        gd = torch.randn((n, d, d, d, c), generator=g, device=dev).bfloat16()
        got = resize.downsample2x_bwd(gd, (n, 2*d, 2*d, 2*d, c))
        ref = resize.downsample2x_bwd_plain(gd, (n, 2*d, 2*d, 2*d, c))
        print("down bwd", (n, d, c), rel(got, ref), flush=True)

    print("== the fine step: batch 2 vs mean of two batch-1 runs")
    exp = get_preset("cascade")
    ucfg, cfg, _ = stage_config(exp, "fine")
    model, _ = init_stage(ucfg, cfg, dev)
    loss_fn = make_microbatch_loss(cfg, ucfg.stem_downsample, lowres=True)
    for patch in (64, 128):
        imgs = torch.randn((2, patch, patch, patch, 4), generator=g, device=dev).bfloat16()
        segs = torch.randint(0, 4, (2, patch, patch, patch), generator=g, device=dev).long()
        model.zero_grad(); loss_fn(model, imgs, segs)[0].backward()
        g2 = {k: p.grad.clone() for k, p in model.named_parameters()}
        acc = {}
        for i in range(2):
            model.zero_grad(); loss_fn(model, imgs[i:i+1], segs[i:i+1])[0].backward()
            for k, p in model.named_parameters():
                acc[k] = acc.get(k, 0) + p.grad / 2
        worst = sorted(((rel(acc[k], g2[k]), k) for k in g2), reverse=True)[:6]
        print("patch", patch, "worst params", [(round(v, 4), k) for v, k in worst], flush=True)
        # plain path on the CPU, bf16, same weights and batch
        if patch == 64:
            cpu = copy.deepcopy(model).cpu()
            cpu.zero_grad(); loss_fn(cpu, imgs.cpu(), segs.cpu())[0].backward()
            c2 = {k: p.grad.clone() for k, p in cpu.named_parameters()}
            cacc = {}
            for i in range(2):
                cpu.zero_grad(); loss_fn(cpu, imgs[i:i+1].cpu(), segs[i:i+1].cpu())[0].backward()
                for k, p in cpu.named_parameters():
                    cacc[k] = cacc.get(k, 0) + p.grad / 2
            worst = sorted(((rel(cacc[k], c2[k]), k) for k in c2), reverse=True)[:4]
            print("  CPU plain: batch 2 vs mean of batch 1", [(round(v, 4), k) for v, k in worst])
            worst = sorted(((rel(g2[k].cpu(), c2[k]), k) for k in c2), reverse=True)[:4]
            print("  card N2 vs CPU N2", [(round(v, 4), k) for v, k in worst])
            worst = sorted(((rel(acc[k].cpu(), cacc[k]), k) for k in c2), reverse=True)[:4]
            print("  card N1-mean vs CPU N1-mean", [(round(v, 4), k) for v, k in worst], flush=True)
    print("== the same at an f32 compute dtype: relative L2 of all grads")
    import dataclasses

    model32, _ = init_stage(dataclasses.replace(ucfg, compute_dtype="float32"),
                            cfg, dev)
    for patch in (64, 128):
        imgs = torch.randn((2, patch, patch, patch, 4), generator=g, device=dev)
        segs = torch.randint(0, 4, (2, patch, patch, patch), generator=g,
                             device=dev).long()
        runs = {"card": (model32, imgs, segs)}
        if patch == 64:
            runs["CPU plain"] = (copy.deepcopy(model32).cpu(), imgs.cpu(), segs.cpu())
        grads = {}
        for where, (m, x, y) in runs.items():
            m.zero_grad()
            loss_fn(m, x, y)[0].backward()
            g2 = {k: p.grad.clone() for k, p in m.named_parameters()}
            acc = {}
            for i in range(2):
                m.zero_grad()
                loss_fn(m, x[i:i + 1], y[i:i + 1])[0].backward()
                for k, p in m.named_parameters():
                    acc[k] = acc.get(k, 0) + p.grad / 2
            grads[where] = (g2, acc)
            print(f"patch {patch} {where}: batch 2 vs mean of batch 1, relative "
                  f"L2 {l2(acc, g2):.3e}, worst parameter "
                  f"{max(((rel(acc[k], g2[k]), k) for k in g2))}", flush=True)
        if len(grads) == 2:
            cg, cpu = grads["card"][0], grads["CPU plain"][0]
            print(f"patch {patch}: card batch 2 vs CPU batch 2, relative L2 "
                  f"{l2({k: v.cpu() for k, v in cg.items()}, cpu):.3e}", flush=True)
    return 0


def l2(a, b) -> float:
    """Relative L2 distance of two gradient dicts: |a - b| / |b|."""
    num = sum(float((a[k].float() - b[k].float()).square().sum()) for k in b)
    den = sum(float(b[k].float().square().sum()) for k in b)
    return (num / max(den, 1e-60)) ** 0.5


@contextlib.contextmanager
def float64_plain():
    """Run the port's plain path in f64: the compute dtype f64, ``.float()``
    a no-op on f64 tensors, and the f32 buffers the plain ops allocate made
    f64 (the plain versions compute in f32 by design; this diagnostic alone
    widens them). Restored on exit."""
    from brats2019_tpu_torch.configs import presets

    saved = {"dtype": presets.UNetConfig.dtype, "float": torch.Tensor.float}
    names = ("empty", "zeros", "ones", "full")
    saved.update({n: getattr(torch, n) for n in names})

    def widened(fn):
        def call(*a, **k):
            if k.get("dtype") == torch.float32:
                k["dtype"] = torch.float64
            return fn(*a, **k)
        return call

    presets.UNetConfig.dtype = property(lambda self: torch.float64)
    torch.Tensor.float = (lambda t, *a, **k: t if t.dtype == torch.float64
                          else saved["float"](t, *a, **k))
    for n in names:
        setattr(torch, n, widened(saved[n]))
    try:
        yield
    finally:
        presets.UNetConfig.dtype = saved["dtype"]
        torch.Tensor.float = saved["float"]
        for n in names:
            setattr(torch, n, saved[n])


def as_f64(model):
    """A CPU f64 copy of ``model`` (its convs' compute dtype f64 too)."""
    m = copy.deepcopy(model).cpu().double()
    for mod in m.modules():
        if hasattr(mod, "compute_dtype"):
            mod.compute_dtype = torch.float64
    return m


def batch_grads(model, loss_fn, x, y):
    """(batch grads, mean of the per-sample grads), detached."""
    model.zero_grad(set_to_none=True)
    loss_fn(model, x, y)[0].backward()
    full = {k: p.grad.detach().clone() for k, p in model.named_parameters()}
    acc = {}
    for i in range(x.shape[0]):
        model.zero_grad(set_to_none=True)
        loss_fn(model, x[i:i + 1], y[i:i + 1])[0].backward()
        for k, p in model.named_parameters():
            acc[k] = acc.get(k, 0) + p.grad.detach() / x.shape[0]
    model.zero_grad(set_to_none=True)
    return full, acc


def cpu64(d):
    return {k: v.detach().cpu().double() for k, v in d.items()}


F64_PATCHES = (64, 128)   # the fine step's patches
F64_VOLUME = 64           # the whole-volume check's edge


def f64_main(dev) -> int:
    """``--f64``: the card's f32 grads against f64 ones (module docstring)."""
    import dataclasses
    import subprocess

    from brats2019_tpu_torch.parallel.mesh import make_mesh
    from brats2019_tpu_torch.parallel.spatial_unet import make_spatial_train_grad

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}; CPU threads {torch.get_num_threads()} of "
          f"{os.cpu_count()}", flush=True)
    exp = get_preset("cascade")
    ucfg, cfg, _ = stage_config(exp, "fine")
    ucfg = dataclasses.replace(ucfg, compute_dtype="float32")
    model, _ = init_stage(ucfg, cfg, dev)
    loss_fn = make_microbatch_loss(cfg, ucfg.stem_downsample, lowres=True)
    g = torch.Generator().manual_seed(1)
    print("== the fine step at f32 on the card against f64 on the CPU "
          "(relative L2 over all grads)", flush=True)
    for patch in F64_PATCHES:
        x = torch.randn((2, patch, patch, patch, 4), generator=g)
        y = torch.randint(0, 4, (2, patch, patch, patch), generator=g)
        c2, c1 = batch_grads(model, loss_fn, x.to(dev), y.to(dev))
        c2, c1 = cpu64(c2), cpu64(c1)
        m64 = as_f64(model)
        with float64_plain():
            d2, d1 = batch_grads(m64, loss_fn, x.double(), y)
        del m64
        e2, e1 = l2(c2, d2), l2(c1, d2)
        print(f"patch {patch}: f64 batch 2 vs mean of batch 1 {l2(d1, d2):.3e}; "
              f"card f32 batch 2 vs f64 {e2:.3e}; card f32 mean of batch 1 vs "
              f"f64 {e1:.3e} (sum {e2 + e1:.3e}); card batch 2 vs mean of "
              f"batch 1 {l2(c1, c2):.3e}", flush=True)
    v = F64_VOLUME
    print(f"== whole-volume grads (voxel-mean cross-entropy, one {v}^3 "
          "volume): card f32 against f64 on the CPU", flush=True)
    x = torch.randn((v, v, v, 4), generator=g)
    y = torch.randint(0, 4, (v, v, v), generator=g)

    def ce(m, xs, ys):
        logp = torch.log_softmax(m(xs).float(), dim=-1)
        return -logp.gather(-1, ys.long().unsqueeze(-1)).mean()

    model.zero_grad(set_to_none=True)
    ce(model, x[None].to(dev), y[None].to(dev)).backward()
    whole = cpu64({k: p.grad for k, p in model.named_parameters()})
    _, sharded = make_spatial_train_grad(make_mesh([dev] * 2), model)(
        x.to(dev), y.to(dev))
    sharded = cpu64(sharded)
    m64 = as_f64(model)
    with float64_plain():
        ce(m64, x[None].double(), y[None]).backward()
    exact = {k: p.grad.detach() for k, p in m64.named_parameters()}
    ew, es = l2(whole, exact), l2(sharded, exact)
    print(f"unsharded f32 vs f64 {ew:.3e}; 2 shards f32 vs f64 {es:.3e} (sum "
          f"{ew + es:.3e}); 2 shards vs unsharded {l2(sharded, whole):.3e}",
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
