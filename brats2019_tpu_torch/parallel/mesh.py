"""The device mesh and its collectives (reference:
``brats2019_tpu/parallel/mesh.py``, whose one ``('data',)`` axis over every
chip this keeps).

Design. A mesh is an ordered list of **shards**, each a torch device, and
optionally a ``torch.distributed`` process group over several processes with
the same number of shards each. Global shard ``g`` of process ``rank`` with
``n`` local shards is ``rank * n + j``; everything that must not depend on
the process layout (the training RNG, the case cursor, the sweep's item
striping) keys on ``g``.

* ``make_mesh()`` takes every local CUDA device; tests pass ``["cpu"] * N``;
  ``["cuda:0"] * N`` puts N shards on one card, which runs the whole
  decomposition there (each shard an ordinary tensor, launched in turn).
* :func:`psum` / :func:`pmean` add the local shards' tensors on the first
  shard's device in shard order, then ``dist.all_reduce`` across processes.
  The in-process order is fixed, so one process gives bitwise repeatable
  sums; across processes the all-reduce's own order applies.
* The gloo backend is asked for CPU tensors only: a CUDA tensor is staged
  through a pinned host buffer for every gloo collective and every
  point-to-point transfer (gloo's CUDA support is partial). NCCL takes the
  CUDA tensors as they are.
* :func:`initialize_distributed` is ``init_process_group`` read from the
  environment (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``/``MASTER_PORT``):
  NCCL for CUDA shards, gloo for the CPU. With no world declared, or a world
  of 1, it does nothing, as ``jax.distributed.initialize`` on one host; a
  declared world that fails to come up raises.

The mesh is data parallelism (``train/step.py``), spatial sharding of one
volume (``parallel/spatial.py``, ``parallel/spatial_unet.py``) and the
multi-device predictor (``infer/multichip.py``). TP/PP/EP do not apply to
this model family, as in the reference.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence

import torch

DATA_AXIS = "data"


@dataclasses.dataclass(frozen=True)
class MeshEnv:
    devices: tuple                    # local shards' torch.devices, in order
    rank: int = 0
    world: int = 1
    backend: Optional[str] = None     # "nccl" | "gloo" when world > 1

    @property
    def n_local(self) -> int:
        return len(self.devices)

    @property
    def n_data(self) -> int:
        """Shards over all processes (the reference's ``mesh.shape['data']``)."""
        return self.n_local * self.world

    @property
    def first(self) -> torch.device:
        return self.devices[0]

    def shard_index(self, j: int) -> int:
        """Global index of local shard ``j``."""
        return self.rank * self.n_local + j

    @property
    def multiprocess(self) -> bool:
        return self.world > 1

    def local_devices(self) -> List[torch.device]:
        """The distinct devices of the local shards, in first-use order."""
        out: List[torch.device] = []
        for d in self.devices:
            if d not in out:
                out.append(d)
        return out


def _as_device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", 0)
    return d


def make_mesh(devices: Optional[Sequence] = None) -> MeshEnv:
    """A 1-D mesh over the given shard devices (default: every local CUDA
    device; a host without a card raises, as every entry point runs on the
    card unless asked for the CPU), joined with the other processes of an
    initialised process group. Every process must bring as many shards."""
    import torch.distributed as dist

    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh(): no CUDA device; pass devices=['cpu'] * N to "
                "run the mesh on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = tuple(_as_device(d) for d in devices)
    if not devs:
        raise ValueError("make_mesh needs at least one device")
    for d in devs:
        if d.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"mesh device {d} requested but "
                               "torch.cuda.is_available() is False")
        if d.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported mesh device {d}")
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        rank, world = dist.get_rank(), dist.get_world_size()
        counts = [None] * world
        dist.all_gather_object(counts, len(devs))
        if len(set(counts)) != 1:
            raise ValueError(f"every process must bring as many shards: {counts}")
        return MeshEnv(devices=devs, rank=rank, world=world,
                       backend=dist.get_backend())
    return MeshEnv(devices=devs)


def initialize_distributed(backend: Optional[str] = None) -> bool:
    """Bring up the process group from the environment. Returns True when a
    world of more than one process is up, False when none is declared (a
    no-op). ``backend`` defaults to NCCL when CUDA is available, else gloo.
    A declared world (``WORLD_SIZE`` > 1) that fails to come up raises: a
    misconfigured launch must not degrade silently to one process."""
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_world_size() > 1
    world = int(os.environ.get("WORLD_SIZE", "1") or 1)
    if world <= 1:
        return False
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    dist.init_process_group(backend=backend, init_method="env://",
                            world_size=world,
                            rank=int(os.environ["RANK"]))
    return True


# ------------------------------------------------------------- collectives --

def _staged(env: MeshEnv, t: torch.Tensor) -> bool:
    return env.backend == "gloo" and t.is_cuda


def _to_host(t: torch.Tensor) -> torch.Tensor:
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return host.copy_(t)


def all_reduce_(env: MeshEnv, t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` over the processes in place (nothing at one process)."""
    if not env.multiprocess:
        return t
    import torch.distributed as dist

    if _staged(env, t):
        host = _to_host(t)
        dist.all_reduce(host)
        t.copy_(host)
    else:
        dist.all_reduce(t)
    return t


def psum(env: MeshEnv, tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """Sum of one tensor per local shard over the whole mesh, on the first
    shard's device: the local shards added in shard order (a fixed f32
    order), then all-reduced across processes."""
    if len(tensors) != env.n_local:
        raise ValueError(f"psum: {len(tensors)} tensors for {env.n_local} shards")
    dev = env.first
    acc = tensors[0].to(dev, copy=True)
    for t in tensors[1:]:
        acc += t.to(dev)
    return all_reduce_(env, acc)


def pmean(env: MeshEnv, tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return psum(env, tensors) / env.n_data


def gather_shards(env: MeshEnv, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Every global shard's tensor (same shape on every shard), in global
    shard order, on the first local device: the local ones moved there, the
    other processes' all-gathered."""
    dev = env.first
    local = [t.to(dev) for t in tensors]
    if not env.multiprocess:
        return local
    import torch.distributed as dist

    stacked = torch.stack(local)
    staged = _staged(env, stacked)
    src = _to_host(stacked) if staged else stacked.contiguous()
    outs = [torch.empty_like(src) for _ in range(env.world)]
    dist.all_gather(outs, src)
    return [o.to(dev)[j] for o in outs for j in range(env.n_local)]


def all_gather_objects(env: MeshEnv, obj) -> list:
    """One picklable object per process, in rank order."""
    if not env.multiprocess:
        return [obj]
    import torch.distributed as dist

    out = [None] * env.world
    dist.all_gather_object(out, obj)
    return out


def barrier(env: MeshEnv) -> None:
    if env.multiprocess:
        import torch.distributed as dist

        dist.barrier()


def send_recv(env: MeshEnv, send_to: Optional[int], send: Optional[torch.Tensor],
              recv_from: Optional[int], like: Optional[torch.Tensor]
              ) -> Optional[torch.Tensor]:
    """Point-to-point: send ``send`` to process ``send_to`` and receive a
    tensor shaped like ``like`` from ``recv_from`` (either may be None), both
    posted before either is waited on. Returns the received tensor on
    ``like``'s device."""
    import torch.distributed as dist

    ops, host_send, recv = [], None, None
    if send_to is not None:
        host_send = _to_host(send) if _staged(env, send) else send.contiguous()
        ops.append(dist.P2POp(dist.isend, host_send, send_to))
    if recv_from is not None:
        recv = (torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
                if _staged(env, like) else torch.empty_like(like))
        ops.append(dist.P2POp(dist.irecv, recv, recv_from))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    if recv is None:
        return None
    return recv.to(like.device)
