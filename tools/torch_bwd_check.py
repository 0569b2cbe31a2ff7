#!/usr/bin/env python3
"""Standalone check of the PyTorch port's IN+act backward
(``csrc/in_act_bwd.cu``) and 2x up backward (``csrc/resize2x.cu``) on a CUDA
card.

    timeout 300 python3 tools/torch_bwd_check.py            # correctness
    timeout 600 python3 tools/torch_bwd_check.py --time     # + ms per shape

Builds both sources (and, for ``--time``, ``in_act_bwd.cu`` five times more
with ``-DIN_ACT_BWD_PROBE=0..4``, which stop after a step), prints ptxas's
registers and spills, then at every shape the cascade's fine and coarse
train steps give them, plus edge shapes: the
IN+act backward against its plain version and the blocked plain version (dx
max|d|/max|ref| <= 1e-2, dgamma/dbeta 1e-3), the up backward against its
plain version (1 bf16 ulp), also read from the concat gradient's up half in
place; a repeat run bitwise equal, and a CUDA-graph replay equal to the
eager call. ``--time``: device ms (CUDA-graph replay) per shape of the fine
step: the new kernel, the Triton kernels it replaces (prev), the bound; for
the IN+act backward also the share of x and g held in shared memory and the
probe builds' times: the launch and one grid barrier alone (0), up to the
end of phase 1's loads and folds (1), the block reduction (2), the first
barrier (3), the column merge and the second barrier (4).
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from brats2019_tpu_torch.configs.presets import get_preset  # noqa: E402
from brats2019_tpu_torch.ops import _build, norm, resize  # noqa: E402
from chip_smoke import (bf16_ulps, bound_terms, card_line, device_ms,  # noqa: E402
                        train_calls, unet_calls)

EDGE_NORM = [(1, 6, 7, 5, 8), (1, 3, 5, 7, 48), (1, 1, 4, 1, 64), (1, 64, 64, 64, 48),
             (1, 9, 7, 11, 16), (2, 16, 16, 8, 64), (1, 8, 8, 8, 320)]
EDGE_UP = [(1, 4, 4, 4, 8), (1, 5, 3, 9, 48), (1, 1, 1, 1, 16), (2, 6, 10, 14, 16),
           (1, 3, 4, 2, 320)]


PROBES = range(5)


def _probe_lib(k):
    return _build.load_library(f"in_act_bwd_probe{k}", ["in_act_bwd.cu"],
                               norm._SIG,
                               extra_flags=(f"-DIN_ACT_BWD_PROBE={k}",))


def probe(k, x, g, gam, bet, mean, rstd):
    """Probe build k on the real plan (dx is not written)."""
    n, d, h, w, c = x.shape
    plan = norm.plan_in_bwd(n, d * h * w, c, _build.sm_count(x.device))
    part = torch.empty(2 * n * (plan.bps + 1) * c, dtype=torch.float32,
                       device=x.device)
    out = torch.empty(c, dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    bar = torch.zeros(2, dtype=torch.int32, device=x.device)
    rc = _probe_lib(k).in_act_bwd_ndhwc_bf16(
        x.data_ptr(), g.data_ptr(), dx.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
        gam.data_ptr(), bet.data_ptr(), part.data_ptr(), out.data_ptr(),
        out.data_ptr(), bar.data_ptr(), n, d * h * w, c,
        1, plan.bps, plan.threads, plan.keep, plan.smem,
        torch.cuda.current_stream().cuda_stream)
    _build.check(rc, f"in_act_bwd probe {k}")


def norm_inputs(shape, dev, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn(shape, generator=gen, device=dev) * 3 + 1).bfloat16()
    g = torch.randn(shape, generator=gen, device=dev).bfloat16()
    gam = torch.rand(shape[-1], generator=gen, device=dev) + 0.5
    bet = torch.randn(shape[-1], generator=gen, device=dev) * 0.2
    _, mean, rstd = norm._plain_stats(x, gam, bet, 1e-5, "relu")
    return x, g, gam, bet, mean, rstd


def graph_equal(fn, want) -> bool:
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    out = out if isinstance(out, tuple) else (out,)
    want = want if isinstance(want, tuple) else (want,)
    return all(torch.equal(a, b) for a, b in zip(out, want))


def check_norm(shapes, dev) -> int:
    rel = lambda a, b: ((a.float() - b.float()).abs().max()
                        / b.float().abs().max().clamp_min(1e-30)).item()
    sms = _build.sm_count(dev)
    failures = 0
    for shape in dict.fromkeys(shapes):
        args = norm_inputs(shape, dev)
        c0 = norm.instance_norm_act_bwd.launches_cuda
        got = norm.instance_norm_act_bwd_kernel(*args)
        again = norm.instance_norm_act_bwd_kernel(*args)
        blocked = norm.instance_norm_act_bwd_blocked_plain(*args, sms=sms)
        ref = norm.instance_norm_act_bwd_plain(*args)
        torch.cuda.synchronize()
        on_cuda = norm.instance_norm_act_bwd.launches_cuda - c0
        errs = [max(rel(got[0], r[0]), 0) for r in (ref, blocked)]
        sums = max(rel(got[i], r[i]) for r in (ref, blocked) for i in (1, 2))
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        graphed = graph_equal(lambda: norm.instance_norm_act_bwd_kernel(*args), got)
        ok = max(errs) <= 1e-2 and sums <= 1e-3 and same and graphed and on_cuda == 2
        failures += not ok
        plan = norm.plan_in_bwd(shape[0], shape[1] * shape[2] * shape[3],
                                shape[4], sms)
        print(f"  [{'PASS' if ok else 'FAIL'}] IN+act bwd {shape}: dx vs plain "
              f"{errs[0]:.3e}, vs blocked plain {errs[1]:.3e} (tol 1e-2), "
              f"dgamma/dbeta {sums:.3e} (tol 1e-3), repeat bitwise {same}, "
              f"graph replay equal {graphed}, {on_cuda}/2 launches on "
              f"in_act_bwd.cu; plan {plan}", flush=True)
    return failures


def check_up(shapes, dev) -> int:
    failures = 0
    for shape, cs in dict.fromkeys(shapes):
        n, d, h, w, c = shape
        gen = torch.Generator(device=dev).manual_seed(1)
        cat = torch.randn((n, 2 * d, 2 * h, 2 * w, c + cs), generator=gen,
                          device=dev).bfloat16()
        g = cat[..., :c]
        c0 = resize.upsample2x_bwd.launches_cuda
        got = resize.upsample2x_bwd_kernel(g)
        again = resize.upsample2x_bwd_kernel(g)
        contig = resize.upsample2x_bwd_kernel(g.contiguous())
        ref = resize.upsample2x_bwd_plain(g)
        torch.cuda.synchronize()
        on_cuda = resize.upsample2x_bwd.launches_cuda - c0
        err = bf16_ulps(got, ref)
        same = torch.equal(got, again) and torch.equal(got, contig)
        graphed = graph_equal(lambda: resize.upsample2x_bwd_kernel(g), got)
        ok = err <= 1 and same and graphed and on_cuda == 3
        failures += not ok
        print(f"  [{'PASS' if ok else 'FAIL'}] up bwd {shape} from a concat "
              f"gradient of {c + cs} channels: {err:.2f} bf16 ulp (tol 1), "
              f"repeat and contiguous copy bitwise {same}, graph replay equal "
              f"{graphed}, {on_cuda}/3 launches on resize2x.cu", flush=True)
    return failures


def step_shapes():
    exp = get_preset("cascade")
    out = {}
    for stage, cfg, patch in (("fine", exp.unet, exp.train.patch),
                              ("coarse", exp.coarse_unet, exp.train.coarse_patch)):
        calls = train_calls(cfg, 1, patch)
        fwd = unet_calls(cfg, 1, patch)
        ups = []
        for i, (name, sh) in enumerate(fwd):
            if name == "upsample2x":
                ups.append((sh, fwd[i + 1][1][4] - sh[4]))
        out[stage] = ([sh for name, sh in calls if name == "instance_norm_act_bwd"],
                      ups)
    return out


def time_fine(dev, card) -> None:
    norms, ups = step_shapes()["fine"]
    sms = _build.sm_count(dev)
    print(f"== fine train step on {card} (device ms, CUDA-graph replay)", flush=True)
    tot = dict.fromkeys(("new", "prev", "barrier", "bound"), 0.0)
    for shape in norms:
        args = norm_inputs(shape, dev)
        reps = 10
        new = device_ms(lambda: norm.instance_norm_act_bwd_kernel(*args), reps)
        prev = device_ms(lambda: norm.instance_norm_act_bwd_kernel_triton(*args), reps)
        plan = norm.plan_in_bwd(shape[0], shape[1] * shape[2] * shape[3], shape[4], sms)
        # the probe builds stop steps of the grid form
        steps = ([0.0] * len(PROBES) if plan.column else
                 [device_ms(lambda: probe(k, *args), reps) for k in PROBES])
        bar = steps[0]
        bound = max(bound_terms("instance_norm_act_bwd", shape))
        held = min(1.0, plan.keep / (-(-(shape[1] * shape[2] * shape[3]) // plan.bps)
                                     * (shape[4] // 8)))
        for k, v in zip(tot, (new, prev, bar, bound)):
            tot[k] += v
        form = (f"column form, {shape[4] // 8} blocks of {plan.threads} threads"
                if plan.column else
                f"{plan.bps} blocks of {plan.threads} threads, {100 * held:.0f}% "
                f"of x and g held; probes (ms to the end of): launch + barrier "
                f"{steps[0]:.4f}, phase 1 {steps[1]:.4f}, block reduction "
                f"{steps[2]:.4f}, barrier 1 {steps[3]:.4f}, merge + barrier 2 "
                f"{steps[4]:.4f}, dx {new:.4f}")
        print(f"  IN+act bwd {shape}: in_act_bwd.cu {new:.4f} ms, Triton (prev) "
              f"{prev:.4f}, bound {bound:.4f} ({100 * bound / new:.0f}% of it); "
              f"{form}", flush=True)
    print(f"  IN+act bwd per fine step ({len(norms)} calls): {tot['new']:.4f} ms, "
          f"prev {tot['prev']:.4f}, barrier alone {tot['barrier']:.4f}, bound "
          f"{tot['bound']:.4f} on {card}", flush=True)
    tot = dict.fromkeys(("new", "strided", "prev", "bound"), 0.0)
    for shape, cs in ups:
        n, d, h, w, c = shape
        cat = torch.randn((n, 2 * d, 2 * h, 2 * w, c + cs), device=dev).bfloat16()
        g = cat[..., :c]
        gc = g.contiguous()
        new = device_ms(lambda: resize.upsample2x_bwd_kernel(gc), 10)
        strided = device_ms(lambda: resize.upsample2x_bwd_kernel(g), 10)
        prev = device_ms(lambda: resize.upsample2x_bwd_kernel_triton(g), 10)
        bound = max(bound_terms("upsample2x_bwd", shape))
        for k, v in zip(tot, (new, strided, prev, bound)):
            tot[k] += v
        print(f"  up bwd {shape}: resize2x.cu {new:.4f} ms (from the concat "
              f"gradient in place {strided:.4f}), Triton with the slab copy "
              f"(prev) {prev:.4f}, bound {bound:.4f}", flush=True)
    print(f"  up bwd per fine step ({len(ups)} calls): {tot['new']:.4f} ms, in "
          f"place {tot['strided']:.4f}, prev {tot['prev']:.4f}, bound "
          f"{tot['bound']:.4f} on {card}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--time", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("error: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    loaders = [norm._lib, resize._lib] + (
        [lambda k=k: _probe_lib(k) for k in PROBES] if args.time else [])
    _build.build_all(loaders)
    for lib in ("in_act_bwd", "resize2x"):
        log = [ln.strip() for ln in _build.build_logs.get(lib, "(cached)").splitlines()
               if "registers" in ln or "spill" in ln or "error" in ln.lower()]
        print(f"  ptxas, {lib}: " + " | ".join(log), flush=True)
    shapes = step_shapes()
    failures = check_norm(shapes["fine"][0] + shapes["coarse"][0] + EDGE_NORM, dev)
    failures += check_up(shapes["fine"][1] + shapes["coarse"][1]
                         + [(s, 8) for s in EDGE_UP], dev)
    if args.time:
        time_fine(dev, card)
    print(f"== {failures} failure(s)", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
