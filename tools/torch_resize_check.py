#!/usr/bin/env python3
"""Standalone check of the PyTorch port's 2x resizes on a CUDA card: the 2x
trilinear up (bf16 and f32) and the f32 2x down.

    timeout 300 python3 tools/torch_resize_check.py            # correctness
    timeout 600 python3 tools/torch_resize_check.py --time     # + ms per shape
    timeout 600 python3 tools/torch_resize_check.py --probe    # the Triton kernel
    timeout 600 python3 tools/torch_resize_check.py --f32 [--time] [--probe] [--parent OLD.py]
    timeout 600 python3 tools/torch_resize_check.py --parent-cu OLD.cu  # bf16 up bwd vs an earlier build

Holds ``csrc/resize2x.cu`` (``ops.resize.upsample2x_kernel``) and its concat
form (``upsample2x_concat_kernel``) against ``upsample2x_plain`` at edge
shapes (extent 1, odd extents, C not a multiple of 64, a C that is not a
multiple of 8 and goes to the Triton kernel): up within 1 bf16 ulp, the
concat's skip half bitwise equal to skip, a repeat run bitwise equal.
``--time``: device ms (CUDA-graph replay) at every upsample shape of the
flagship predict path: resize2x.cu, the Triton ``_up2x_kernel`` (prev), the
bound, ``F.interpolate``, and the concat op against the Triton up followed by
``torch.cat``; sums per volume. ``--probe``: the Triton kernel as it is, with
C a compile-time constant (no runtime division), with one load per output
instead of eight gathers, and with neither, at the same shapes: what holds it
back.

``--f32``: the f32 instance (``upsample2x_ndhwc_f32``, 4 channels a 16-byte
piece) instead: at edge shapes (extent 1, odd extents, a partial chunk, two
chunks, C % 4 != 0 going to Triton by plan) the up within 1e-6 of the plain
up, into a buffer at a channel pitch and offset with the other channels
untouched, the concat's skip half bitwise, a repeat run bitwise, launches on
resize2x.cu and into the concat; ``--time``: at every f32 up (the accuracy
config's tile batch, one ``smoke`` and one ``unit`` train step) resize2x.cu
against the Triton up (prev) and the up + concat against the Triton up
copied into the buffer (prev), each in turns (prev, this, this, prev), the
bound and ``F.interpolate``; ``--parent FILE`` (an earlier
``triton_resize.py``) times its ``launch_up`` as the prev instead. The f32
2x down on resize2x.cu (``downsample2x_ndhwc_f32``) likewise: at edge shapes
(odd extents, C = 4 and 12, N = 2, a transposed and a misaligned input,
C % 4 != 0 going to Triton by plan) within 1e-6 of the plain down, a repeat
run bitwise, launches on resize2x.cu; ``--time``: at every f32 down of the
same three (the accuracy tile batch, a ``smoke`` and a ``unit`` step)
against the Triton down (prev; ``--parent``: its ``launch_down``), in turns,
the bound and ``F.avg_pool3d``. The two f32 backwards on resize2x.cu: the
up backward (``upsample2x_bwd_ndhwc_f32``) at ``smoke``'s and ``unit``'s ups
read in place from a concat gradient at its real pitch and at edge shapes
(odd extents, a size-1 axis, C 12, N = 2 over two chunks), in both instances
(8 and 4 pieces a chunk) and the planned one: within 1e-6 of the plain
version, in place bitwise equal to a contiguous copy, a repeat and a CUDA-graph
replay bitwise, the plan's shared memory equal to the kernel's
(``upsample2x_bwd_smem_bytes``), a misaligned g copied,
C or pitch % 4 != 0 going to Triton by plan; the down backward
(``downsample2x_bwd_ndhwc_f32``) bitwise equal to the plain version at edge
shapes (odd extents, N = 2, C 4 and 12, a transposed and a misaligned g);
``--time``: per ``smoke`` and ``unit`` step, the up backward in every
instance against the Triton kernel after the copy of the up half (prev;
``--parent``: its ``launch_up_bwd``), and the down backward against the
Triton kernel (prev; ``--parent``: its ``launch_down_bwd``), in turns, beside
the bound and ``F.interpolate`` / ``F.avg_pool3d``'s autograd backward.
``--f32 --probe``: where the f32 up backward's time goes, from probe builds
of resize2x.cu (no fills, no reduction or stores, neither) beside the build,
in both instances at the ``smoke`` and ``unit`` shapes, in turns.

``--parent-cu FILE`` (an earlier ``resize2x.cu``, whose
``upsample2x_bwd_ndhwc_bf16`` takes no d run): the bf16 up backward through
the wrapper held bitwise equal to that build's at every up backward of the
flagship's coarse and fine train steps, read in place at the concat's pitch,
and at edge shapes (an odd extent, a size-1 axis, two chunks at a wide
pitch), each timed beside it in turns.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import importlib.util
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
import triton  # noqa: E402
import triton.language as tl  # noqa: E402

from brats2019_tpu_torch.configs.presets import get_preset  # noqa: E402
from brats2019_tpu_torch.ops import resize  # noqa: E402
from brats2019_tpu_torch.ops.triton_resize import _BLOCK, _taps, _w_interp  # noqa: E402,F401
from chip_smoke import (bf16_ulps, bound_terms, device_ms, library_ms,  # noqa: E402
                        train_calls, unet_calls)

SMALL = [
    # (N, D, H, W, C), skip channels
    ((1, 1, 1, 1, 8), 8), ((2, 5, 6, 7, 16), 24), ((1, 3, 4, 2, 320), 256),
    ((1, 9, 3, 17, 72), 8), ((2, 1, 5, 1, 40), 16), ((1, 12, 14, 10, 192), 96),
    ((1, 7, 6, 5, 3), 5), ((8, 4, 4, 4, 128), 64),
]


@triton.jit
def _up2x_probe_kernel(x_ptr, y_ptr, D, H, W, C, CC: tl.constexpr,
                       CONST_C: tl.constexpr, GATHER: tl.constexpr,
                       BLOCK: tl.constexpr):
    row = tl.program_id(0)
    blk = tl.program_id(1)
    oh = row % (2 * H)
    t = row // (2 * H)
    od = t % (2 * D)
    n = t // (2 * D)
    offs = blk * BLOCK + tl.arange(0, BLOCK)
    if CONST_C:
        mask = offs < 2 * W * CC
        ow = offs // CC
        c = offs % CC
        cw = CC
    else:
        mask = offs < 2 * W * C
        ow = offs // C
        c = offs % C
        cw = C
    nd = n.to(tl.int64) * D
    if GATHER:
        d0, d1, wd0, wd1 = _taps(od, D)
        h0, h1, wh0, wh1 = _taps(oh, H)
        w0, w1, ww0, ww1 = _taps(ow, W)
        r00 = _w_interp(x_ptr, ((nd + d0) * H + h0) * W, w0, w1, ww0, ww1, c, cw, mask)
        r01 = _w_interp(x_ptr, ((nd + d0) * H + h1) * W, w0, w1, ww0, ww1, c, cw, mask)
        r10 = _w_interp(x_ptr, ((nd + d1) * H + h0) * W, w0, w1, ww0, ww1, c, cw, mask)
        r11 = _w_interp(x_ptr, ((nd + d1) * H + h1) * W, w0, w1, ww0, ww1, c, cw, mask)
        acc = wd0 * (wh0 * r00 + wh1 * r01) + wd1 * (wh0 * r10 + wh1 * r11)
    else:
        src = (((nd + od // 2) * H + oh // 2) * W + ow // 2) * cw + c
        acc = tl.load(x_ptr + src, mask=mask, other=0.0).to(tl.float32)
    out = row.to(tl.int64) * 2 * W * cw + offs
    tl.store(y_ptr + out, acc.to(y_ptr.dtype.element_ty), mask=mask)


def probe(x, y, const_c: bool, gather: bool) -> None:
    n, d, h, w, c = x.shape
    grid = (n * 4 * d * h, triton.cdiv(2 * w * c, _BLOCK))
    _up2x_probe_kernel[grid](x, y, d, h, w, c, CC=c, CONST_C=const_c,
                             GATHER=gather, BLOCK=_BLOCK, num_warps=4)


def predict_up_calls():
    """((N, D, H, W, C), skip channels) -> calls per volume on the flagship
    predict path; the skip's channels are the next conv's input less C."""
    exp = get_preset("cascade")
    out = collections.Counter()
    for cfg, batch, spatial in ((exp.coarse_unet, 1, exp.infer.coarse_shape),
                                (exp.unet, 8, exp.infer.roi_shape)):
        calls = unet_calls(cfg, batch, spatial)
        for i, (name, shape) in enumerate(calls):
            if name == "upsample2x":
                out[(shape, calls[i + 1][1][4] - shape[4])] += 1
    return out


def make(shape, cs, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(shape, generator=g, device=dev).bfloat16()
    n, d, h, w, _ = shape
    skip = torch.randn((n, 2 * d, 2 * h, 2 * w, cs), generator=g,
                       device=dev).bfloat16()
    return x, skip


def check_small(dev) -> int:
    failures = 0
    for shape, cs in SMALL:
        x, skip = make(shape, cs, dev)
        before = (resize.upsample2x.launches_cuda, resize.upsample2x.launches_concat)
        got = resize.upsample2x_kernel(x)
        again = resize.upsample2x_kernel(x)
        cat = resize.upsample2x_concat_kernel(x, skip)
        ref = resize.upsample2x_plain(x)
        torch.cuda.synchronize()
        took = (resize.upsample2x.launches_cuda - before[0],
                resize.upsample2x.launches_concat - before[1])
        cuda = shape[4] % 8 == 0 and (shape[4] + cs) % 8 == 0
        err = bf16_ulps(got, ref)
        cat_err = bf16_ulps(cat[..., :shape[4]], ref)
        ok = (err <= 1 and cat_err <= 1 and torch.equal(got, again)
              and torch.equal(cat[..., shape[4]:], skip)
              and took == ((3, 1) if cuda else (0, 0)))
        failures += not ok
        print(f"  [{'PASS' if ok else 'FAIL'}] {shape} + skip {cs}: up {err:.2f} "
              f"bf16 ulp, into the concat {cat_err:.2f} (tol 1), skip half "
              f"bitwise, repeat bitwise, launches on resize2x.cu / into the "
              f"concat {took}", flush=True)
    return failures


def time_shapes(dev, card) -> None:
    print(f"== 2x up on {card} (device ms, CUDA-graph replay)", flush=True)
    tot = collections.Counter()
    for (shape, cs), count in predict_up_calls().items():
        x, skip = make(shape, cs, dev)
        reps = 10
        row = {
            "resize2x.cu": device_ms(lambda: resize.upsample2x_kernel(x), reps),
            "triton (prev)": device_ms(
                lambda: resize.upsample2x_kernel_triton(x), reps),
            "bound": max(bound_terms("upsample2x", shape)),
            "F.interpolate": library_ms("upsample2x", x, reps),
            "concat op": device_ms(
                lambda: resize.upsample2x_concat_kernel(x, skip), reps),
            "triton up + cat (prev)": device_ms(lambda: torch.cat(
                [resize.upsample2x_kernel_triton(x), skip], -1), reps),
        }
        for k, v in row.items():
            tot[k] += count * v
        print(f"  {shape} + skip {cs} x{count}: "
              + ", ".join(f"{k} {v:.4f}" for k, v in row.items()), flush=True)
    print("  sums per volume: " + ", ".join(f"{k} {v:.4f}" for k, v in tot.items()),
          flush=True)


def run_probe(dev, card) -> None:
    print(f"== probe of the Triton _up2x_kernel on {card} (device ms)", flush=True)
    tot = collections.Counter()
    for (shape, _), count in predict_up_calls().items():
        x, _ = make(shape, 8, dev)
        n, d, h, w, c = shape
        y = torch.empty((n, 2 * d, 2 * h, 2 * w, c), dtype=x.dtype, device=dev)
        row = {}
        for label, const_c, gather in (("as is", False, True),
                                       ("C constant", True, True),
                                       ("one load", False, False),
                                       ("neither", True, False)):
            row[label] = device_ms(lambda: probe(x, y, const_c, gather), 10)
        ref = resize.upsample2x_kernel_triton(x)
        probe(x, y, True, True)
        torch.cuda.synchronize()
        same = torch.equal(y, ref)
        row["bound"] = max(bound_terms("upsample2x", shape))
        for k, v in row.items():
            tot[k] += count * v
        print(f"  {shape} x{count}: " + ", ".join(f"{k} {v:.4f}" for k, v in row.items())
              + f"; C-constant form bitwise equal to the kernel: {same}", flush=True)
    print("  sums per volume: " + ", ".join(f"{k} {v:.4f}" for k, v in tot.items()),
          flush=True)


# ------------------------------------------------------------ the f32 up --

F32_SMALL = [
    # (N, D, H, W, C), skip channels
    ((1, 1, 1, 1, 4), 4), ((2, 5, 7, 9, 12), 8), ((1, 3, 4, 2, 40), 8),
    ((1, 9, 3, 17, 36), 12), ((2, 1, 5, 1, 8), 4), ((1, 7, 6, 5, 6), 2),
    ((8, 16, 16, 16, 16), 8),
]


def f32_ups():
    """{what: [((N, D, H, W, C), skip channels), ...]}: each f32 up, one
    entry a call, of the accuracy config's tile batch and one ``smoke`` and
    one ``unit`` train step."""
    from chip_smoke import accuracy_exp, up_concats

    acc = accuracy_exp()
    smoke, unit = get_preset("smoke"), get_preset("unit")
    return {"accuracy tile batch (8, 32^3)": up_concats(unet_calls(acc.unet, 8, acc.infer.tile)),
            "smoke train step (1, 64^3)": up_concats(unet_calls(smoke.unet, 1, smoke.train.patch)),
            "unit train step (1, 16^3)": up_concats(unet_calls(unit.unet, 1, unit.train.patch))}


def f32_check(dev) -> int:
    failures = 0
    rel = lambda a, b: ((a - b).abs().max() / b.abs().max()).item()
    shapes = F32_SMALL + list(dict.fromkeys(
        c for v in f32_ups().values() for c in v))
    for shape, cs in shapes:
        g = torch.Generator(device=dev).manual_seed(1)
        x = torch.randn(shape, generator=g, device=dev)
        n, d, h, w, c = shape
        skip = torch.randn((n, 2 * d, 2 * h, 2 * w, cs), generator=g, device=dev)
        cuda = resize.plan_resize("upsample2x", c, torch.float32, c + cs) == "resize2x.cu"
        before = (resize.upsample2x.launches_cuda, resize.upsample2x.launches_concat,
                  resize.upsample2x.launches_f32)
        got = resize.upsample2x_kernel(x)
        again = resize.upsample2x_kernel(x)
        cat = resize.upsample2x_concat_kernel(x, skip)
        ref = resize.upsample2x_plain(x)
        torch.cuda.synchronize()
        took = tuple(a - b for a, b in zip(
            (resize.upsample2x.launches_cuda, resize.upsample2x.launches_concat,
             resize.upsample2x.launches_f32), before))
        err, cat_err = rel(got, ref), rel(cat[..., :c], ref)
        pitched = True
        if cuda:     # at a pitch and an offset, the other channels untouched
            buf = torch.full((n, 2 * d, 2 * h, 2 * w, c + cs + 4), 7.0, device=dev)
            resize._launch_up_cuda(x, buf, 4)
            torch.cuda.synchronize()
            rest = torch.cat([buf[..., :4], buf[..., 4 + c:]], -1)
            pitched = rel(buf[..., 4:4 + c], ref) <= 1e-6 and bool((rest == 7.0).all())
        ok = (err <= 1e-6 and cat_err <= 1e-6 and pitched and torch.equal(got, again)
              and torch.equal(cat[..., c:], skip)
              and took == ((3, 1, 3) if cuda else (0, 0, 3)))
        failures += not ok
        print(f"  [{'PASS' if ok else 'FAIL'}] f32 {shape} + skip {cs}: up "
              f"max|d|/max|ref| {err:.1e} (bitwise the plain up: "
              f"{bool(torch.equal(got, ref))}), into the concat {cat_err:.1e} "
              f"(tol 1e-6), at pitch {c + cs + 4} offset 4 {pitched}, skip half "
              f"bitwise, repeat bitwise; launches (resize2x.cu, into the concat, "
              f"f32) {took}", flush=True)
    return failures


F32_DOWN_EDGE = [(1, 2, 2, 2, 4), (2, 5, 7, 9, 12), (1, 3, 8, 17, 8), (8, 32, 32, 32, 8),
                 (1, 64, 64, 64, 8), (1, 16, 16, 16, 4), (2, 9, 4, 6, 40), (1, 6, 6, 6, 6)]


def f32_downs():
    """{what: [(N, D, H, W, C), ...]}: each f32 down, one entry a call, of the
    accuracy config's tile batch and one ``smoke`` and one ``unit`` step."""
    from chip_smoke import accuracy_exp

    acc = accuracy_exp()
    smoke, unit = get_preset("smoke"), get_preset("unit")
    runs = {"accuracy tile batch (8, 32^3)": unet_calls(acc.unet, 8, acc.infer.tile),
            "smoke train step (1, 64^3)": unet_calls(smoke.unet, 1, smoke.train.patch),
            "unit train step (1, 16^3)": unet_calls(unit.unet, 1, unit.train.patch)}
    return {k: [sh for name, sh in v if name == "downsample2x"] for k, v in runs.items()}


def f32_down_check(dev) -> int:
    failures = 0
    rel = lambda a, b: ((a - b).abs().max() / b.abs().max()).item()
    shapes = F32_DOWN_EDGE + [sh for v in f32_downs().values() for sh in v]
    for shape in dict.fromkeys(shapes):
        g = torch.Generator(device=dev).manual_seed(3)
        x = torch.randn(shape, generator=g, device=dev)
        cuda = resize.plan_resize("downsample2x", shape[4], torch.float32) == "resize2x.cu"
        before = (resize.downsample2x.launches_cuda, resize.downsample2x.launches_f32)
        got = resize.downsample2x_kernel(x)
        again = resize.downsample2x_kernel(x)
        # a transposed view and a misaligned one: copied for the kernel
        xt = x.transpose(1, 2).contiguous().transpose(1, 2)
        buf = torch.empty(x.numel() + 1, device=dev)
        xm = buf[1:].view(shape)
        xm.copy_(x)
        odd = [resize.downsample2x_kernel(v) for v in (xt, xm)]
        ref = resize.downsample2x_plain(x)
        torch.cuda.synchronize()
        took = (resize.downsample2x.launches_cuda - before[0],
                resize.downsample2x.launches_f32 - before[1])
        err = rel(got, ref)
        same = torch.equal(got, again) and all(torch.equal(got, v) for v in odd)
        ok = (err <= 1e-6 and same and got.shape == ref.shape
              and took == ((4, 4) if cuda else (0, 4)))
        failures += not ok
        print(f"  [{'PASS' if ok else 'FAIL'}] f32 down {shape}: max|d|/max|ref| "
              f"{err:.1e} (tol 1e-6; bitwise the plain down: "
              f"{bool(torch.equal(got, ref))}), repeat, transposed and "
              f"misaligned inputs bitwise {same}; launches (resize2x.cu, f32) "
              f"{took}", flush=True)
    return failures


def f32_down_time(dev, card, parent) -> None:
    print(f"== f32 2x down on {card} (device ms, CUDA-graph replay, in turns)",
          flush=True)
    timed = {}
    for shape in dict.fromkeys(sh for v in f32_downs().values() for sh in v):
        g = torch.Generator(device=dev).manual_seed(4)
        x = torch.randn(shape, generator=g, device=dev)
        n, d, h, w, c = shape
        if parent is not None:
            def old():
                y = torch.empty((n, d // 2, h // 2, w // 2, c), device=dev)
                parent.launch_down(x, y)
                return y
        else:
            old = lambda: resize.downsample2x_kernel_triton(x)
        mine = lambda: resize.downsample2x_kernel(x)
        t = [device_ms(f, 20) for f in (old, mine, mine, old)]
        row = {"triton (prev)": min(t[0], t[3]), "resize2x.cu": min(t[1], t[2]),
               "bound": max(bound_terms("downsample2x", shape, itemsize=4)),
               "F.avg_pool3d": library_ms("downsample2x", x, 20)}
        timed[shape] = row
        print(f"  {shape}: " + ", ".join(f"{k} {v:.4f}" for k, v in row.items()),
              flush=True)
    for what, downs in f32_downs().items():
        tot = collections.Counter()
        for sh in downs:
            tot.update(timed[sh])
        print(f"  sums per {what}, {len(downs)} downs: "
              + ", ".join(f"{k} {v:.4f}" for k, v in tot.items())
              + f"; prev / this {tot['triton (prev)'] / tot['resize2x.cu']:.2f}x",
              flush=True)


def f32_time(dev, card, parent) -> None:
    print(f"== f32 2x up on {card} (device ms, CUDA-graph replay, in turns)",
          flush=True)
    timed = {}
    for shape, cs in dict.fromkeys(c for v in f32_ups().values() for c in v):
        g = torch.Generator(device=dev).manual_seed(2)
        x = torch.randn(shape, generator=g, device=dev)
        n, d, h, w, c = shape
        skip = torch.randn((n, 2 * d, 2 * h, 2 * w, cs), generator=g, device=dev)
        if parent is not None:
            def old_up():
                y = torch.empty((n, 2 * d, 2 * h, 2 * w, c), device=dev)
                parent.launch_up(x, y)
                return y
        else:
            old_up = lambda: resize.upsample2x_kernel_triton(x)

        def old_cat():
            buf = torch.empty((n, 2 * d, 2 * h, 2 * w, c + cs), device=dev)
            buf[..., :c] = old_up()
            buf[..., c:] = skip
            return buf

        mine = lambda: resize.upsample2x_kernel(x)
        mine_cat = lambda: resize.upsample2x_concat_kernel(x, skip)
        t = [device_ms(f, 10) for f in (old_up, mine, mine, old_up)]
        row = {"triton (prev)": min(t[0], t[3]), "resize2x.cu": min(t[1], t[2])}
        t = [device_ms(f, 10) for f in (old_cat, mine_cat, mine_cat, old_cat)]
        row["triton up + copy (prev)"] = min(t[0], t[3])
        row["up into the concat"] = min(t[1], t[2])
        row["bound"] = max(bound_terms("upsample2x", shape, itemsize=4))
        row["F.interpolate"] = library_ms("upsample2x", x, 10)
        timed[(shape, cs)] = row
        print(f"  {shape} + skip {cs}: " + ", ".join(f"{k} {v:.4f}" for k, v in row.items()),
              flush=True)
    for what, ups in f32_ups().items():
        tot = collections.Counter()
        for u in ups:
            for k, v in timed[u].items():
                tot[k] += v
        print(f"  sums per {what}, {len(ups)} ups: "
              + ", ".join(f"{k} {v:.4f}" for k, v in tot.items())
              + f"; up prev / this {tot['triton (prev)'] / tot['resize2x.cu']:.2f}x, "
              f"concat prev / this {tot['triton up + copy (prev)'] / tot['up into the concat']:.2f}x",
              flush=True)


# --------------------------------------------------- the f32 backwards --

F32_UP_BWD_EDGE = [
    # dx (N, D, H, W, C), the concat gradient's channel pitch
    ((1, 5, 3, 9, 16), 24), ((1, 1, 7, 1, 32), 48), ((1, 4, 4, 4, 12), 20),
    ((2, 3, 6, 40, 40), 44), ((1, 1, 1, 1, 4), 4),
]
F32_DOWN_BWD_EDGE = [(2, 9, 7, 13, 12), (1, 5, 6, 7, 4), (1, 2, 3, 2, 4),
                     (2, 6, 10, 4, 8), (8, 32, 32, 32, 8)]


def f32_bwds():
    """{what: ([(up backward dx shape, concat pitch)], [down backward dx
    shape])}: each call of one ``smoke`` and one ``unit`` train step."""
    out = {}
    for preset, what in (("smoke", "smoke train step (1, 64^3)"),
                         ("unit", "unit train step (1, 16^3)")):
        cfg = get_preset(preset)
        fwd = unet_calls(cfg.unet, 1, cfg.train.patch)
        ups = [(sh, fwd[i + 1][1][4]) for i, (name, sh) in enumerate(fwd)
               if name == "upsample2x"]
        downs = [sh for name, sh in train_calls(cfg.unet, 1, cfg.train.patch)
                 if name == "downsample2x_bwd"]
        out[what] = (ups, downs)
    return out


def _graph_equal(fn, want) -> bool:
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    graph.replay()
    torch.cuda.synchronize()
    return bool(torch.equal(out, want))


def _up_bwd_inputs(shape, pitch, dev, seed):
    n, d, h, w, c = shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    cat = torch.randn((n, 2 * d, 2 * h, 2 * w, pitch), generator=gen, device=dev)
    return cat[..., :c]


def _up_bwd_forced(g, pitch, plan):
    dx = torch.empty((g.shape[0],) + tuple(v // 2 for v in g.shape[1:4])
                     + (g.shape[4],), device=g.device)
    resize._launch_up_bwd_cuda(g, dx, pitch, plan)
    return dx


def f32_up_bwd_check(dev) -> int:
    failures = 0
    rel = lambda a, b: ((a - b).abs().max() / b.abs().max()).item()
    lib, sms = resize._lib(), torch.cuda.get_device_properties(dev).multi_processor_count
    shapes = [u for v in f32_bwds().values() for u in v[0]] + F32_UP_BWD_EDGE
    for shape, pitch in dict.fromkeys(shapes):
        n, d, h, w, c = shape
        g = _up_bwd_inputs(shape, pitch, dev, 5)
        ref = resize.upsample2x_bwd_plain(g)
        planned = resize.plan_up_bwd(n, d, h, w, c, torch.float32, sms)
        for pieces in resize.UP_BWD_PIECES:
            plan = resize.plan_up_bwd(n, d, h, w, c, torch.float32, sms, pieces)
            got = _up_bwd_forced(g, pitch, plan)
            again = _up_bwd_forced(g, pitch, plan)
            contig = _up_bwd_forced(g.contiguous(), c, plan)
            graphed = _graph_equal(lambda: _up_bwd_forced(g, pitch, plan), got)
            torch.cuda.synchronize()
            err = rel(got, ref)
            same = torch.equal(got, again) and torch.equal(got, contig) and graphed
            smem = lib.upsample2x_bwd_smem_bytes(pieces)
            ok = err <= 1e-6 and same and smem == plan.smem
            failures += not ok
            print(f"  [{'PASS' if ok else 'FAIL'}] f32 up bwd {shape} from pitch "
                  f"{pitch}, {pieces} pieces{' (planned)' if pieces == planned.pieces else ''}"
                  f": max|d|/max|ref| {err:.1e} (tol 1e-6), repeat, contiguous "
                  f"copy and graph replay bitwise {same}; tile {plan.tile} td "
                  f"{plan.td}, {plan.blocks} blocks, {plan.smem} B shared "
                  f"(kernel {smem})", flush=True)
        before = (resize.upsample2x_bwd.launches_cuda, resize.upsample2x_bwd.launches_f32)
        got = resize.upsample2x_bwd_kernel(g)
        torch.cuda.synchronize()
        took = (resize.upsample2x_bwd.launches_cuda - before[0],
                resize.upsample2x_bwd.launches_f32 - before[1])
        ok = took == (1, 1) and torch.equal(
            got, _up_bwd_forced(g, pitch, planned))
        failures += not ok
        print(f"  [{'PASS' if ok else 'FAIL'}] f32 up bwd {shape} through the "
              f"wrapper: the planned instance ({planned.pieces} pieces), launches "
              f"(resize2x.cu, f32) {took}", flush=True)
    # a misaligned g is copied; C or the pitch off the pieces go to Triton
    for what, g, cuda in (
            ("misaligned", _up_bwd_inputs((1, 3, 4, 5, 20), 24, dev, 6)[..., 1:17], 1),
            ("C 6", _up_bwd_inputs((1, 3, 4, 5, 6), 8, dev, 7), 0),
            ("pitch 14", _up_bwd_inputs((1, 3, 4, 5, 12), 14, dev, 8), 0)):
        before = resize.upsample2x_bwd.launches_cuda
        got = resize.upsample2x_bwd_kernel(g)
        torch.cuda.synchronize()
        on = resize.upsample2x_bwd.launches_cuda - before
        err = rel(got, resize.upsample2x_bwd_plain(g))
        ok = on == cuda and err <= 1e-6
        failures += not ok
        print(f"  [{'PASS' if ok else 'FAIL'}] f32 up bwd, {what}: {on} launch on "
              f"resize2x.cu (expected {cuda}), max|d|/max|ref| {err:.1e}", flush=True)
    return failures


def f32_down_bwd_check(dev) -> int:
    failures = 0
    shapes = [sh for v in f32_bwds().values() for sh in v[1]] + F32_DOWN_BWD_EDGE
    for shape in dict.fromkeys(shapes):
        n, d, h, w, c = shape
        gen = torch.Generator(device=dev).manual_seed(9)
        g = torch.randn((n, d // 2, h // 2, w // 2, c), generator=gen, device=dev)
        before = (resize.downsample2x_bwd.launches_cuda,
                  resize.downsample2x_bwd.launches_f32)
        got = resize.downsample2x_bwd_kernel(g, shape)
        again = resize.downsample2x_bwd_kernel(g, shape)
        gt = g.transpose(1, 2).contiguous().transpose(1, 2)
        buf = torch.empty(g.numel() + 1, device=dev)
        gm = buf[1:].view(g.shape)
        gm.copy_(g)
        odd = [resize.downsample2x_bwd_kernel(v, shape) for v in (gt, gm)]
        ref = resize.downsample2x_bwd_plain(g, shape)
        torch.cuda.synchronize()
        took = (resize.downsample2x_bwd.launches_cuda - before[0],
                resize.downsample2x_bwd.launches_f32 - before[1])
        graphed = _graph_equal(lambda: resize.downsample2x_bwd_kernel(g, shape), got)
        bitwise = bool(torch.equal(got, ref))
        same = (torch.equal(got, again) and all(torch.equal(got, v) for v in odd)
                and graphed)
        ok = bitwise and same and took == (4, 4)
        failures += not ok
        print(f"  [{'PASS' if ok else 'FAIL'}] f32 down bwd {shape}: bitwise the "
              f"plain version {bitwise}, repeat, transposed, misaligned and graph "
              f"replay bitwise {same}; launches (resize2x.cu, f32) {took}", flush=True)
    return failures


def f32_bwd_time(dev, card, parent) -> None:
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"== f32 backwards on {card} (device ms, CUDA-graph replay, in turns)",
          flush=True)
    up_rows, down_rows = {}, {}
    for what, (ups, downs) in f32_bwds().items():
        for shape, pitch in ups:
            if (shape, pitch) in up_rows:
                continue
            n, d, h, w, c = shape
            g = _up_bwd_inputs(shape, pitch, dev, 10)
            if parent is not None:
                def old():
                    dx = torch.empty(shape, device=dev)
                    parent.launch_up_bwd(g.contiguous(), dx)
                    return dx
            else:
                old = lambda: resize.upsample2x_bwd_kernel_triton(g)
            mine = lambda: resize.upsample2x_bwd_kernel(g)
            t = [device_ms(f, 20) for f in (old, mine, mine, old)]
            planned = resize.plan_up_bwd(n, d, h, w, c, torch.float32, sms)
            row = {"triton after the copy (prev)": min(t[0], t[3]),
                   "resize2x.cu in place (planned)": min(t[1], t[2])}
            tds = []
            for pieces in resize.UP_BWD_PIECES:
                plan = resize.plan_up_bwd(n, d, h, w, c, torch.float32, sms, pieces)
                tds.append(f"{pieces}: td {plan.td}, {plan.blocks} blocks")
                row[f"{pieces} pieces"] = device_ms(
                    lambda: _up_bwd_forced(g, pitch, plan), 20)
            row["bound"] = max(bound_terms("upsample2x_bwd", shape, itemsize=4))
            row["F.interpolate bwd"] = library_ms(
                "upsample2x_bwd", torch.randn(shape, device=dev), 20, gy=g.contiguous())
            up_rows[(shape, pitch)] = row
            print(f"  up bwd {shape} from pitch {pitch} (planned: {planned.pieces} "
                  f"pieces; {'; '.join(tds)}): "
                  + ", ".join(f"{k} {v:.4f}" for k, v in row.items()), flush=True)
        for shape in downs:
            if shape in down_rows:
                continue
            n, d, h, w, c = shape
            gen = torch.Generator(device=dev).manual_seed(11)
            g = torch.randn((n, d // 2, h // 2, w // 2, c), generator=gen, device=dev)
            if parent is not None:
                def old():
                    dx = torch.empty(shape, device=dev)
                    parent.launch_down_bwd(g, dx)
                    return dx
            else:
                old = lambda: resize.downsample2x_bwd_kernel_triton(g, shape)
            mine = lambda: resize.downsample2x_bwd_kernel(g, shape)
            t = [device_ms(f, 20) for f in (old, mine, mine, old)]
            row = {"triton (prev)": min(t[0], t[3]), "resize2x.cu": min(t[1], t[2]),
                   "bound": max(bound_terms("downsample2x_bwd", shape, itemsize=4)),
                   "F.avg_pool3d bwd": library_ms(
                       "downsample2x_bwd", torch.randn(shape, device=dev), 20, gy=g)}
            down_rows[shape] = row
            print(f"  down bwd {shape}: "
                  + ", ".join(f"{k} {v:.4f}" for k, v in row.items()), flush=True)
    for what, (ups, downs) in f32_bwds().items():
        for name, keys, rows in (("up bwds", ups, up_rows), ("down bwds", downs, down_rows)):
            tot = collections.Counter()
            for k in keys:
                tot.update(rows[k])
            print(f"  sums per {what}, {len(keys)} {name}: "
                  + ", ".join(f"{k} {v:.4f}" for k, v in tot.items()), flush=True)


UP_BWD_PROBES = {"no fills": ("-DRESIZE2X_UP_BWD_PROBE=1",),
                 "no reduction or stores": ("-DRESIZE2X_UP_BWD_PROBE=2",),
                 "neither (launch and ring walk)": ("-DRESIZE2X_UP_BWD_PROBE=3",)}


def f32_up_bwd_probe(dev, card) -> None:
    """Where the f32 up backward's time goes: resize2x.cu built with each of
    UP_BWD_PROBES beside the build as it is, at every smoke and unit up
    backward in both instances, in turns (the probes leave dx unwritten)."""
    from brats2019_tpu_torch.ops import _build

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    load = {k: (lambda i=i, v=v: _build.load_library(
        f"resize2x_up_bwd_{i}", ["resize2x.cu"], resize._SIG, extra_flags=v))
        for i, (k, v) in enumerate(UP_BWD_PROBES.items())}
    _build.build_all(list(load.values()))    # one nvcc each, side by side
    libs = {k: fn() for k, fn in load.items()}
    libs["as built"] = resize._lib()
    print(f"== f32 up backward by probe build on {card} (device ms, CUDA-graph "
          f"replay, in turns)", flush=True)
    tot = collections.Counter()
    for what, (ups, _) in f32_bwds().items():
        for shape, pitch in ups:
            n, d, h, w, c = shape
            g = _up_bwd_inputs(shape, pitch, dev, 12)
            for pieces in resize.UP_BWD_PIECES:
                plan = resize.plan_up_bwd(n, d, h, w, c, torch.float32, sms, pieces)

                def run(lib):
                    dx = torch.empty(shape, device=dev)
                    rc = lib.upsample2x_bwd_ndhwc_f32(
                        g.data_ptr(), dx.data_ptr(), n, d, h, w, c, pitch, pieces,
                        plan.td, torch.cuda.current_stream(dev).cuda_stream)
                    _build.check(rc, "upsample2x_bwd probe")
                    return dx

                order = list(libs)
                t = dict.fromkeys(order, float("inf"))
                for k in order + order[::-1]:
                    t[k] = min(t[k], device_ms(lambda: run(libs[k]), 20))
                planned = resize.plan_up_bwd(n, d, h, w, c, torch.float32, sms)
                if pieces == planned.pieces:
                    tot.update({f"{what}: {k}": v for k, v in t.items()})
                print(f"  up bwd {shape} from pitch {pitch}, {pieces} pieces"
                      f"{' (planned)' if pieces == planned.pieces else ''}"
                      f", td {plan.td}, {plan.blocks} blocks: "
                      + ", ".join(f"{k} {v:.4f}" for k, v in t.items()), flush=True)
    print("  sums of the planned instances: "
          + ", ".join(f"{k} {v:.4f}" for k, v in tot.items()), flush=True)


def flagship_up_bwds():
    """[(up backward dx shape, concat pitch)] of one train step of the
    flagship's coarse and fine stages (batch 1 at the train patch)."""
    exp = get_preset("cascade")
    out = []
    for cfg, patch in ((exp.coarse_unet, exp.train.coarse_patch),
                       (exp.unet, exp.train.patch)):
        fwd = unet_calls(cfg, 1, patch)
        out += [(sh, fwd[i + 1][1][4]) for i, (name, sh) in enumerate(fwd)
                if name == "upsample2x"]
    return out


BF16_UP_BWD_EDGE = [((1, 5, 3, 9, 48), 56), ((1, 1, 7, 1, 64), 72),
                    ((2, 6, 10, 4, 128), 192)]


def bf16_up_bwd_parent(dev, card, path) -> int:
    """The bf16 up backward through the wrapper (the plan's d run passed to
    the kernel) against ``path``'s build of ``upsample2x_bwd_ndhwc_bf16``
    (the d run chosen in the kernel's launcher), bitwise, on the same g read
    in place at its pitch; both timed in turns."""
    from brats2019_tpu_torch.ops import _build

    sig = {"upsample2x_bwd_ndhwc_bf16": [ctypes.c_void_p] * 2
           + [ctypes.c_int] * 6 + [ctypes.c_void_p]}
    old_lib = _build.load_library("resize2x_parent", [os.path.abspath(path)], sig)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"== bf16 up backward against {path} on {card} (device ms, CUDA-graph "
          f"replay, in turns)", flush=True)
    failures, tot = 0, collections.Counter()
    for shape, pitch in list(dict.fromkeys(flagship_up_bwds())) + BF16_UP_BWD_EDGE:
        n, d, h, w, c = shape
        gen = torch.Generator(device=dev).manual_seed(13)
        cat = torch.randn((n, 2 * d, 2 * h, 2 * w, pitch), generator=gen,
                          device=dev).bfloat16()
        g = cat[..., :c]

        def old():
            dx = torch.empty(shape, dtype=torch.bfloat16, device=dev)
            rc = old_lib.upsample2x_bwd_ndhwc_bf16(
                g.data_ptr(), dx.data_ptr(), n, d, h, w, c, pitch,
                torch.cuda.current_stream(dev).cuda_stream)
            _build.check(rc, "upsample2x_bwd_ndhwc_bf16 (parent)")
            return dx

        mine = lambda: resize.upsample2x_bwd_kernel(g)
        same = bool(torch.equal(mine(), old()))
        t = [device_ms(f, 20) for f in (old, mine, mine, old)]
        row = {"parent": min(t[0], t[3]), "this tree": min(t[1], t[2])}
        if shape[0] == 1 and shape not in BF16_UP_BWD_EDGE:
            tot.update(row)
        failures += not same
        plan = resize.plan_up_bwd(n, d, h, w, c, torch.bfloat16, sms)
        print(f"  [{'PASS' if same else 'FAIL'}] bf16 up bwd {shape} from pitch "
              f"{pitch} (td {plan.td}, {plan.blocks} blocks): bitwise the "
              f"parent's {same}; " + ", ".join(f"{k} {v:.4f}" for k, v in row.items()),
              flush=True)
    print("  sums over the flagship's coarse and fine up backwards: "
          + ", ".join(f"{k} {v:.4f}" for k, v in tot.items()), flush=True)
    return failures


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--probe", action="store_true",
                    help="the Triton up's probes; with --f32 the f32 up "
                    "backward's probe builds")
    ap.add_argument("--f32", action="store_true",
                    help="check (and time) the f32 instance instead")
    ap.add_argument("--parent", help="with --f32 --time: an earlier "
                    "triton_resize.py whose launch_up, launch_down, "
                    "launch_up_bwd and launch_down_bwd are timed as the prevs")
    ap.add_argument("--parent-cu", help="an earlier resize2x.cu: the bf16 up "
                    "backward held bitwise to its build and timed beside it")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("error: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, triton "
          f"{triton.__version__}; card: {card}", flush=True)
    resize._lib()
    from brats2019_tpu_torch.ops import _build

    print("  ptxas, resize2x: " + " | ".join(
        ln.strip() for ln in _build.build_logs.get("resize2x", "(cached)").splitlines()
        if ln.strip() and "Compiling entry" not in ln), flush=True)
    if args.f32:
        parent = None
        if args.parent:
            spec = importlib.util.spec_from_file_location("parent_triton_resize",
                                                          args.parent)
            parent = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(parent)
        failures = (f32_check(dev) + f32_down_check(dev) + f32_up_bwd_check(dev)
                    + f32_down_bwd_check(dev))
        if args.time:
            f32_time(dev, card, parent)
            f32_down_time(dev, card, parent)
            f32_bwd_time(dev, card, parent)
        if args.probe:
            f32_up_bwd_probe(dev, card)
        if args.parent_cu:
            failures += bf16_up_bwd_parent(dev, card, args.parent_cu)
        print(f"{failures} failure(s)", flush=True)
        return 1 if failures else 0
    failures = check_small(dev)
    if args.parent_cu:
        failures += bf16_up_bwd_parent(dev, card, args.parent_cu)
    if args.probe:
        run_probe(dev, card)
    if args.time:
        time_shapes(dev, card)
    print(f"{failures} failure(s)", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
