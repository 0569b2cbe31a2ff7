"""The forward kernels of the predict path, and the conv's weight gradient,
as ``torch.library`` operators, in the port's namespace ``brats_torch``.

Each operator has a CPU implementation (the plain torch version), a CUDA
implementation (the hand-written kernel's wrapper: its planner, its launch
counters; for the weight gradient, the cuDNN call) and a fake implementation that gives only the outputs' shapes
and dtypes, which is what ``torch.export`` traces with. So the dispatcher
is the device seam, and an exported program (``infer/export_hlo.py``) holds
one ``brats_torch::`` node per kernel call, which launches the same kernel
when the program runs on a card. There is no fallback: a CUDA tensor never
reaches the plain version. Defining an operator imports no ``triton`` and
builds no library; only a CUDA implementation does, at its first call.

The operators are defined where their implementations live
(``ops/conv.py``, ``ops/winograd.py``, ``ops/norm.py``, ``ops/resize.py``);
importing ``brats2019_tpu_torch.ops`` defines them all, which is all that a
consumer of an exported program needs of this package.

:func:`device_const` is the one place where a cached device constant meets
tracing.
"""

from __future__ import annotations

from typing import Callable

import torch

NAMESPACE = "brats_torch"


def define_op(name: str, schema: str, cpu: Callable, cuda: Callable,
              fake: Callable) -> torch._ops.OpOverload:
    """Define ``brats_torch::<name>`` with ``schema`` (arguments and
    results, e.g. ``"(Tensor x) -> Tensor"``) and its CPU, CUDA and fake
    implementations; returns the operator's overload, which callers call."""
    qual = f"{NAMESPACE}::{name}"
    torch.library.define(qual, schema)
    torch.library.impl(qual, "CPU", cpu)
    torch.library.impl(qual, "CUDA", cuda)
    torch.library.register_fake(qual, fake)
    return getattr(getattr(torch.ops, NAMESPACE), name).default



def device_const(cache: dict, key, build: Callable[[], torch.Tensor]
                 ) -> torch.Tensor:
    """``build()``, a constant on a device, kept in ``cache`` under ``key``:
    built once (the host-to-device copy that builds it waits for the card),
    and not as an inference tensor, so autograd may save it whichever mode
    first asked for it. A traced program (``torch.export``) builds its own
    and leaves the cache alone, so no traced tensor reaches an eager call."""
    if torch.compiler.is_compiling():
        return build()
    if key not in cache:
        with torch.inference_mode(False):
            cache[key] = build()
    return cache[key]
