#!/usr/bin/env python3
"""Standalone check of the PyTorch port's IN+act backward
(``csrc/in_act_bwd.cu``) and 2x up backward (``csrc/resize2x.cu``) on a CUDA
card.

    timeout 300 python3 tools/torch_bwd_check.py            # correctness
    timeout 600 python3 tools/torch_bwd_check.py --time     # + ms per shape
    timeout 600 python3 tools/torch_bwd_check.py --f32 [--time [--probe]] [--parent OLD.py]

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

``--f32``: the f32 instance of ``in_act_bwd.cu`` (``in_act_bwd_ndhwc_f32``,
its column form and its cluster form, 4 channels a 16-byte vector)
instead: at every IN
backward of one ``smoke`` and one ``unit`` train step and at edge shapes (C
= 4 and 12, odd extents, N = 2, the column form, C % 4 != 0 going to Triton
by plan), dx, dgamma and dbeta within 1e-5 of the plain and the blocked
plain version, a repeat run and a CUDA-graph replay bitwise equal, and
the grid, column and cluster forms (at every cluster size and group width
that fits) each within 1e-5 of the plain version and bitwise repeatable.
``--time``: at each shape of a ``smoke`` and a ``unit`` step, in turns
(prev, this, this, prev), the planned kernel against the Triton kernels
(prev; with ``--parent FILE``, an earlier ``triton_norm.py``'s
``launch_bwd``), the bound and the autograd backward of
``F.instance_norm``; every form the kernel takes there (grid, column,
cluster of 2-16 blocks over groups of 1-8 vectors); the sums per step and
where the planned kernel's time goes (``chip_smoke.f32_bwd_breakdown``:
the memset of the grid form's counters, the launch, phase 1, the block
reduction, the barrier, the merge, dx, from probe builds 0-4); with
``--probe`` that for every form at every shape.
"""

from __future__ import annotations

import argparse
import collections
import importlib.util
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from brats2019_tpu_torch.configs.presets import get_preset  # noqa: E402
from brats2019_tpu_torch.ops import _build, norm, resize  # noqa: E402
from chip_smoke import (bf16_ulps, bound_terms, card_line, device_ms,  # noqa: E402
                        in_bwd_probe as probe, in_bwd_probe_lib as _probe_lib,
                        library_ms, train_calls, unet_calls)

EDGE_NORM = [(1, 6, 7, 5, 8), (1, 3, 5, 7, 48), (1, 1, 4, 1, 64), (1, 64, 64, 64, 48),
             (1, 9, 7, 11, 16), (2, 16, 16, 8, 64), (1, 8, 8, 8, 320)]
EDGE_UP = [(1, 4, 4, 4, 8), (1, 5, 3, 9, 48), (1, 1, 1, 1, 16), (2, 6, 10, 14, 16),
           (1, 3, 4, 2, 320)]


PROBES = range(5)


def norm_inputs(shape, dev, seed=0, dtype=torch.bfloat16):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn(shape, generator=gen, device=dev) * 3 + 1).to(dtype)
    g = torch.randn(shape, generator=gen, device=dev).to(dtype)
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


# ------------------------------------------------------ the f32 instance --

F32_EDGE = [(1, 6, 7, 5, 4), (1, 3, 5, 7, 12), (2, 9, 7, 11, 12), (1, 9, 7, 11, 16),
            (2, 16, 16, 8, 8), (1, 1, 4, 1, 8), (1, 12, 11, 17, 24),
            (2, 32, 32, 32, 16), (1, 16, 16, 16, 64), (1, 5, 6, 7, 3)]


def f32_steps():
    """{what: [IN backward shape, one a call]} of one ``smoke`` and one
    ``unit`` train step."""
    out = {}
    for preset in ("smoke", "unit"):
        exp = get_preset(preset)
        calls = train_calls(exp.unet, 1, exp.train.patch)
        out[f"{preset} train step"] = [sh for name, sh in calls
                                       if name == "instance_norm_act_bwd"]
    return out


def plan_launch(plan, args, bar=None):
    """The kernel on ``plan`` (no count), on (N, S, C) views of the inputs."""
    x, g, gam, bet, mean, rstd = args
    n, c = x.shape[0], x.shape[-1]
    x3, g3 = x.view(n, -1, c), g.view(n, -1, c)
    return norm.launch_in_act_bwd(plan, x3, g3, mean, rstd, gam, bet, "relu", bar)


def f32_forms(n, s, c, sms):
    """{label: plan} of every form the f32 kernel takes at (N, S, C): the
    grid form, the column form (N S <= 4096), the cluster form (N = 1) at
    every cluster size of 2-16 and group width of 1-8 vectors that fits."""
    f32 = torch.float32
    forms = {"grid form": norm.grid_plan(n, s, c, sms, f32)}
    if n * s <= 4096:
        forms["column form"] = norm.column_plan(n, s, c, f32)
    if n == 1:
        for width in (1, 2, 4, 8):
            for k in (2, 4, 8, 16):
                p = norm.cluster_plan(s, c, k, width)
                if (c // 4) % width == 0 and k <= s and p.smem <= norm.SMEM_LIMIT:
                    forms[f"cluster {k} x width {width}"] = p
    return forms


def launches(plan, args) -> bool:
    """Whether the card takes ``plan`` (a cluster too large for a GPC is
    refused at launch); run eagerly, outside any graph capture."""
    try:
        plan_launch(plan, args)
        torch.cuda.synchronize()
        return True
    except RuntimeError as e:
        print(f"    plan {plan} refused: {e}", flush=True)
        return False


def _sc_lib():
    """in_act_bwd.cu with the f32 instance on the fenced grid barrier (bf16's)."""
    return _build.load_library("in_act_bwd_sc", ["in_act_bwd.cu"], norm._SIG,
                               extra_flags=("-DIN_ACT_BWD_SC_BARRIER",))


def sc_launch(plan, args):
    """The f32 grid form on ``plan`` built with the fenced barrier, its
    counters zeroed as the port's are."""
    x, g, gam, bet, mean, rstd = args
    n, c = x.shape[0], x.shape[-1]
    lib = _sc_lib()
    dx = torch.empty_like(x)
    part = torch.empty(2 * n * (plan.bps + 1) * c, dtype=torch.float32, device=x.device)
    out = torch.empty(2 * c, dtype=torch.float32, device=x.device)
    bar = torch.zeros(2, dtype=torch.int32, device=x.device)
    stream = torch.cuda.current_stream().cuda_stream
    rc = lib.in_act_bwd_ndhwc_f32(*[t.data_ptr() for t in (x, g, dx, mean, rstd, gam, bet, part)],
                                  out.data_ptr(), out[c:].data_ptr(), bar.data_ptr(),
                                  n, x.numel() // (n * c), c, 1, plan.bps, plan.threads,
                                  plan.keep, plan.smem, stream)
    _build.check(rc, "in_act_bwd (fenced barrier)")
    return dx, out[:c], out[c:]


def f32_check(dev) -> int:
    rel = lambda a, b: ((a.float() - b.float()).abs().max()
                        / b.float().abs().max().clamp_min(1e-30)).item()
    sms = _build.sm_count(dev)
    f32 = torch.float32
    failures = 0
    shapes = [sh for v in f32_steps().values() for sh in v] + F32_EDGE
    for shape in dict.fromkeys(shapes):
        args = norm_inputs(shape, dev, dtype=f32)
        n, d, h, w, c = shape
        s = d * h * w
        cuda = c % 4 == 0 and norm.plan_in_bwd(n, s, c, sms, f32).route == "in_act_bwd.cu"
        c0 = (norm.instance_norm_act_bwd.launches_cuda,
              norm.instance_norm_act_bwd.launches_f32)
        got = norm.instance_norm_act_bwd_kernel(*args)
        again = norm.instance_norm_act_bwd_kernel(*args)
        ref = norm.instance_norm_act_bwd_plain(*args)
        wants = [ref] + ([norm.instance_norm_act_bwd_blocked_plain(*args, sms=sms)]
                         if c % 4 == 0 else [])
        torch.cuda.synchronize()
        took = (norm.instance_norm_act_bwd.launches_cuda - c0[0],
                norm.instance_norm_act_bwd.launches_f32 - c0[1])
        err = max(rel(a, b) for want in wants for a, b in zip(got, want))
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        graphed = graph_equal(lambda: norm.instance_norm_act_bwd_kernel(*args), got)
        what = "Triton by plan"
        forms_ok = True
        if c % 4 == 0:
            what = f"plan {norm.plan_in_bwd(n, s, c, sms, f32)}; every form"
            worst = 0.0
            for label, plan in f32_forms(n, s, c, sms).items():
                if not launches(plan, args):
                    continue
                one = plan_launch(plan, args)
                two = plan_launch(plan, args)
                torch.cuda.synchronize()
                worst = max([worst] + [rel(a.view(b.shape), b) for a, b in zip(one, ref)])
                forms_ok = forms_ok and all(torch.equal(a, b) for a, b in zip(one, two))
            forms_ok = forms_ok and worst <= 1e-5
            what += f" within {worst:.1e} of plain, each repeat bitwise {forms_ok}"
        ok = (err <= 1e-5 and same and graphed and forms_ok
              and took == ((2, 2) if cuda else (0, 2)))
        failures += not ok
        print(f"  [{'PASS' if ok else 'FAIL'}] f32 IN+act bwd {shape}: dx, dgamma, "
              f"dbeta vs plain{' and blocked plain' if c % 4 == 0 else ''} {err:.1e} (tol "
              f"1e-5), repeat bitwise {same}, graph replay equal {graphed}, "
              f"launches (in_act_bwd.cu, f32) {took}; {what}", flush=True)
    return failures


def f32_time(dev, card, parent, breakdowns=False) -> None:
    from chip_smoke import f32_bwd_breakdown, in_bwd_terms

    f32 = torch.float32
    sms = _build.sm_count(dev)
    steps = f32_steps()
    print(f"== f32 IN+act backward on {card} (device ms, CUDA-graph replay)",
          flush=True)
    timed = {}
    for shape in dict.fromkeys(sh for v in steps.values() for sh in v):
        args = norm_inputs(shape, dev, dtype=f32)
        x, g, gam, bet, mean, rstd = args
        n, d, h, w, c = shape
        s = d * h * w
        if parent is not None:
            def prev():
                x3, g3 = x.view(n, s, c), g.view(n, s, c)
                dx3 = torch.empty_like(x3)
                return parent.launch_bwd(x3, g3, dx3, mean, rstd, gam, bet, "relu")
        else:
            prev = lambda: norm.instance_norm_act_bwd_kernel_triton(*args)
        mine = lambda: norm.instance_norm_act_bwd_kernel(*args)
        reps = 20
        t = [device_ms(f, reps) for f in (prev, mine, mine, prev)]
        row = {"this": min(t[1], t[2]), "triton (prev)": min(t[0], t[3]),
               "bound": max(bound_terms("instance_norm_act_bwd", shape, itemsize=4)),
               "library": library_ms("instance_norm_act_bwd", x, reps, gy=g,
                                     gam=gam, bet=bet)}
        plan = norm.plan_in_bwd(n, s, c, sms, f32)
        if plan.route == "in_act_bwd.cu" and not (plan.column or plan.cluster):
            # the grid form's barrier against the fenced one, in turns
            for label, other in (("fenced barrier", lambda: sc_launch(plan, args)),):
                got, want = other(), plan_launch(plan, args)
                torch.cuda.synchronize()
                assert all(torch.equal(a.view(b.shape), b) for a, b in zip(got, want))
                t = [device_ms(f, reps) for f in (other, mine, mine, other)]
                row[f"this against the {label}"] = min(t[1], t[2])
                row[label] = min(t[0], t[3])
        alts = {label: device_ms(lambda p=p: plan_launch(p, args), reps)
                for label, p in f32_forms(n, s, c, sms).items() if launches(p, args)}
        timed[shape] = (row, alts)
        print(f"  {shape}: plan {norm.plan_in_bwd(n, s, c, sms, f32)}; "
              + ", ".join(f"{k} {v:.4f}" for k, v in row.items())
              + "; every form: " + ", ".join(f"{k} {v:.4f}" for k, v in alts.items()),
              flush=True)
        if breakdowns:
            for label, p in f32_forms(n, s, c, sms).items():
                if label in alts and not p.column:
                    terms = in_bwd_terms(p, args, reps)
                    print(f"    {label} by step: " + ", ".join(
                        f"{k} {v:.4f}" for k, v in terms.items()), flush=True)
    for what, shapes in steps.items():
        tot, alt = collections.Counter(), collections.Counter()
        best = 0.0
        for sh in shapes:
            tot.update(timed[sh][0])
            best += min(timed[sh][1].values())
        print(f"  sums per {what}, {len(shapes)} calls: "
              + ", ".join(f"{k} {v:.4f}" for k, v in tot.items())
              + f"; prev / this {tot['triton (prev)'] / tot['this']:.2f}x; the "
              f"fastest form at every call {best:.4f}", flush=True)
        f32_bwd_breakdown(shapes, dev, card, what)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--f32", action="store_true",
                    help="check (and time) the f32 instance instead")
    ap.add_argument("--probe", action="store_true",
                    help="with --f32 --time: every form's time by step at "
                         "every shape (probe builds)")
    ap.add_argument("--parent", help="with --f32 --time: an earlier "
                    "triton_norm.py whose launch_bwd is timed as the prev")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("error: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    loaders = [norm._lib, resize._lib] + (
        [lambda k=k: _probe_lib(k) for k in PROBES] + [_sc_lib] if args.time else [])
    _build.build_all(loaders)
    for lib in ("in_act_bwd", "resize2x"):
        log = [ln.strip() for ln in _build.build_logs.get(lib, "(cached)").splitlines()
               if "registers" in ln or "spill" in ln or "error" in ln.lower()]
        print(f"  ptxas, {lib}: " + " | ".join(log), flush=True)
    if args.f32:
        parent = None
        if args.parent:
            spec = importlib.util.spec_from_file_location("parent_triton_norm",
                                                          args.parent)
            parent = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(parent)
        failures = f32_check(dev)
        if args.time:
            f32_time(dev, card, parent, args.probe)
        print(f"== {failures} failure(s)", flush=True)
        return 1 if failures else 0
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
