"""Multi-process execution of the port's mesh paths (reference:
``brats2019_tpu/parallel/multiprocess.py``).

* :func:`launch_workers` spawns N localhost worker processes
  (``python -m brats2019_tpu_torch.parallel.multiprocess``), each bringing D
  shards, joined into one mesh by ``torch.distributed.init_process_group``
  over ``tcp://localhost:<free port>`` (gloo for CPU shards or shards that
  share a card; NCCL refuses two ranks on one device). Each rank gets its
  ``CUDA_VISIBLE_DEVICES`` (rank r: card r mod the host's cards, or the
  caller's list) and its shard list (``cuda:0`` D times, or ``cpu`` D times).
* :func:`flagship_workload`: the validation workload, run identically by a
  single process and by the workers, so their results compare: a
  data-parallel ``train_stage`` (a pool per shard, background refresh, the
  averaged-gradient step, sharded validation, checkpoints), its resume, and
  the mesh cascade predict (``MultichipPredictor``, mode ``cascade``).
* :func:`parity_workload`: one data-parallel step, one sharded conv and one
  spatially sharded training gradient (halos and InstanceNorm statistics
  across the processes, both ways), the small version the CPU tests run.

Parity contract (:23-28, carried to the port's layouts): the training RNG
and the case cursors key on the global shard index (``train/step.py``,
``data/pipeline.py``), so the process layout is invisible to sampling; with
the same data and seeds, 2 processes x 2 shards give the losses of 1 process
x 4 shards within 1e-5 relative (the cross-process all-reduce adds in its
own order) and the same cascade mask (labels may differ only where the
blended probabilities tie).
"""

from __future__ import annotations

import base64
import dataclasses
import hashlib
import json
import os
import socket
import subprocess
import sys
import zlib
from typing import Dict, List, Optional, Sequence

RESULT_TAG = "MPRESULT:"
THREADS = 2   # a worker's intra-op threads
DTYPE = "bfloat16"   # the workloads' compute dtype, the reference's
# modules no process of the port may import (the workers report theirs)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "ml_dtypes",
             "safetensors", "brats2019_tpu")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def _mask_fields(labels) -> Dict[str, object]:
    import numpy as np

    a = np.ascontiguousarray(labels)
    return {
        "mask_sha1": hashlib.sha1(a).hexdigest(),
        "mask_sum": int(a.sum()),
        "mask_shape": list(a.shape),
        # the whole mask, so a caller can count any cross-layout difference
        "mask_b64": base64.b64encode(zlib.compress(a.tobytes())).decode(),
    }


def decode_mask(result: Dict[str, object]):
    """Inverse of the ``mask_b64`` field: the uint8 label volume."""
    import numpy as np

    return np.frombuffer(zlib.decompress(base64.b64decode(result["mask_b64"])),
                         np.uint8).reshape(result["mask_shape"])


def flagship_workload(data_dir: str, workdir: str, env=None,
                      steps_first: int = 2, steps_resumed: int = 4
                      ) -> Dict[str, object]:
    """Train + resume + mesh cascade predict on ``env`` (default: every
    local card), the flagship topology at 1/8 width (the fine net's s2d stem
    and sub-pixel head; :64-190). One training case, so every pool slot
    holds the same case whatever the layout; fixed seeds. Returns a small
    dict (losses, the mask and its digest) to compare across layouts."""
    import numpy as np

    from ..configs.presets import (ExperimentConfig, InferenceConfig,
                                   TrainConfig, UNetConfig)
    from ..data.synthetic import make_case_arrays
    from ..infer.multichip import MultichipPredictor
    from ..train.loop import train_stage
    from ..utils.weights import init_params
    from .mesh import make_mesh

    env = env or make_mesh()
    case_dirs = sorted(os.path.join(data_dir, d) for d in os.listdir(data_dir)
                       if os.path.isdir(os.path.join(data_dir, d)))
    assert len(case_dirs) >= 2, "flagship_workload needs >= 2 cases (train + val)"
    cfg = TrainConfig(patch=(32, 32, 32), pool_shape=(64, 32, 32),
                      pool_cases_per_device=1, batch_per_device=1,
                      steps=steps_first, warmup_steps=1, log_every=1,
                      eval_every=steps_first, checkpoint_every=steps_first,
                      pool_refresh_every=2)
    ucfg = UNetConfig(levels=4, base_features=8, max_features=40,
                      stem_downsample=2, compute_dtype=DTYPE)
    exp = ExperimentConfig(
        name="mp_flagship", unet=ucfg, coarse_unet=None, train=cfg,
        infer=InferenceConfig(canvas=None, tile=(32, 32, 32), tta_flips=False,
                              cascade=False, compute_dtype=DTYPE),
        workdir=workdir)
    res_a = train_stage(exp, case_dirs[:1], stage="fine",
                        val_dirs=case_dirs[1:2], env=env)
    exp_b = dataclasses.replace(exp, train=dataclasses.replace(
        cfg, steps=steps_resumed))
    res_b = train_stage(exp_b, case_dirs[:1], stage="fine",
                        val_dirs=case_dirs[1:2], env=env)

    cc_ucfg = UNetConfig(levels=2, base_features=4, max_features=8,
                         compute_dtype=DTYPE)
    exp_mc = ExperimentConfig(
        name="mp_cascade",
        unet=UNetConfig(levels=2, base_features=4, max_features=8,
                        stem_downsample=2, compute_dtype=DTYPE),
        coarse_unet=cc_ucfg,
        train=TrainConfig(pool_shape=(32, 32, 32)),
        infer=InferenceConfig(canvas=(32, 32, 32), tile=(16, 16, 16),
                              cascade=True, tta_flips=True,
                              roi_shape=(16, 16, 16), coarse_shape=(16, 16, 16),
                              min_component_voxels=0, et_min_voxels=0,
                              compute_dtype=DTYPE),
        workdir=os.path.join(workdir, "mc"))
    mp = MultichipPredictor(exp_mc, init_params(exp_mc.unet, 3), mode="cascade",
                            env=env, params_coarse=init_params(cc_ucfg, 4))
    img, _ = make_case_arrays(seed=7, shape=(40, 36, 28))
    labels = mp.predict_arrays(img)
    return {
        "process_count": env.world,
        "shard_count": env.n_data,
        "loss_first": float(res_a.final_metrics.get("loss", float("nan"))),
        "loss_resumed": float(res_b.final_metrics.get("loss", float("nan"))),
        **_mask_fields(np.asarray(labels)),
    }


def parity_workload(data_dir: str, env) -> Dict[str, object]:
    """One data-parallel step of the ``unit`` net (a pool a shard from
    ``data_dir``'s cases), one sharded conv of a seeded (16, 12, 8, 4)
    volume and the ``unit`` net's spatially sharded training gradient on
    it: the loss, the gradient norm, the updated params, the conv output,
    the spatial loss and grads (as float lists), to compare across process
    layouts."""
    import numpy as np
    import torch

    from ..configs.presets import get_preset
    from ..models.unet3d import UNet3D
    from ..train.loop import _Pools
    from ..train.step import Optimizer, TrainStep, make_microbatch_loss
    from ..utils.weights import init_params, state_dict_from_flat
    from .spatial import make_sharded_conv3d
    from .spatial_unet import make_spatial_train_grad

    exp = get_preset("unit")
    cfg = dataclasses.replace(exp.train, pool_refresh_every=0)
    case_dirs = sorted(os.path.join(data_dir, d) for d in os.listdir(data_dir)
                       if os.path.isdir(os.path.join(data_dir, d)))
    model = UNet3D(exp.unet)
    model.load_state_dict(state_dict_from_flat(init_params(exp.unet, 0)))
    model = model.to(env.first).train()
    step = TrainStep(model, cfg, make_microbatch_loss(cfg), env=env,
                     opt=Optimizer(dict(model.named_parameters()), cfg))
    pools = _Pools(env, case_dirs, cfg.pool_shape, cfg.pool_cases_per_device,
                   1, cfg.seed, None)
    aux = step(pools.pools, 0)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((16, 12, 8, 4)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 3, 3, 4, 6)).astype(np.float32))
    y = make_sharded_conv3d(env)(x.to(env.first), w.to(env.first))
    spatial_model = UNet3D(exp.unet)
    spatial_model.load_state_dict(state_dict_from_flat(init_params(exp.unet, 1)))
    labels = torch.from_numpy(rng.integers(0, 4, (16, 12, 8)))
    s_loss, s_grads = make_spatial_train_grad(env, spatial_model.to(env.first))(
        x.to(env.first), labels.to(env.first))
    return {
        "process_count": env.world,
        "shard_count": env.n_data,
        "loss": float(aux["loss"]),
        "grad_norm": float(aux["grad_norm"]),
        "params": {k: v.detach().cpu().reshape(-1).tolist()
                   for k, v in model.state_dict().items()},
        "conv": y.cpu().reshape(-1).tolist(),
        "conv_shape": list(y.shape),
        "spatial_loss": float(s_loss),
        "spatial_grads": {k: v.cpu().reshape(-1).tolist()
                          for k, v in s_grads.items()},
    }


def worker_env(rank: int, device: str, cuda_visible: Optional[Sequence[str]]
               ) -> Dict[str, str]:
    """A worker's environment: the checkout on ``PYTHONPATH``, its card
    (``CUDA_VISIBLE_DEVICES``), ``THREADS`` intra-op threads."""
    env = dict(os.environ)
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = (repo + os.pathsep + env["PYTHONPATH"]
                         if env.get("PYTHONPATH") else repo)
    env["OMP_NUM_THREADS"] = str(THREADS)
    if device == "cuda":
        if cuda_visible is None:
            import torch

            cards = max(torch.cuda.device_count(), 1)
            env["CUDA_VISIBLE_DEVICES"] = str(rank % cards)
        else:
            env["CUDA_VISIBLE_DEVICES"] = str(cuda_visible[rank])
    return env


def launch_workers(
    data_dir: str,
    workdir: str,
    num_processes: int = 2,
    shards_per_process: int = 2,
    device: str = "cuda",
    backend: Optional[str] = None,
    workload: str = "flagship",
    timeout: float = 900.0,
    steps_first: int = 2,
    steps_resumed: int = 4,
    cuda_visible: Optional[Sequence[str]] = None,
) -> List[Dict[str, object]]:
    """Spawn ``num_processes`` localhost workers into one mesh and run
    ``workload`` ("flagship" or "parity") on it, on the card unless
    ``device="cpu"``. ``backend`` defaults to
    NCCL for CUDA shards of one process (or one card a process) and gloo
    otherwise. Returns the per-process result dicts (all of which must
    agree); raises on any worker failure, with that worker's output. Every
    worker still running at the end is killed."""
    if device not in ("cpu", "cuda"):
        raise ValueError(f"worker device must be cpu or cuda, got {device!r}")
    if backend is None:
        # NCCL refuses two ranks on one card
        if device == "cuda":
            import torch

            cards = (len(set(cuda_visible)) if cuda_visible is not None
                     else torch.cuda.device_count())
        backend = ("nccl" if device == "cuda" and cards >= num_processes
                   else "gloo")
    init = f"tcp://localhost:{free_port()}"
    procs = []
    try:
        for rank in range(num_processes):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "brats2019_tpu_torch.parallel.multiprocess",
                 "--rank", str(rank), "--world-size", str(num_processes),
                 "--init-method", init, "--backend", backend,
                 "--shards", str(shards_per_process), "--device", device,
                 "--workload", workload, "--data-dir", data_dir,
                 "--workdir", workdir, "--steps-first", str(steps_first),
                 "--steps-resumed", str(steps_resumed)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                env=worker_env(rank, device, cuda_visible)))
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for rank, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"multiprocess worker {rank} failed "
                               f"(rc={p.returncode}):\n{out[-4000:]}")
        line = next((ln for ln in out.splitlines()
                     if ln.startswith(RESULT_TAG)), None)
        if line is None:
            raise RuntimeError(f"worker {rank} printed no {RESULT_TAG} line:\n"
                               f"{out[-4000:]}")
        results.append(json.loads(line[len(RESULT_TAG):]))
    return results


def _worker_main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m brats2019_tpu_torch.parallel.multiprocess",
        description="One worker of launch_workers: joins the process group, "
                    "runs the workload on its shards, prints one "
                    f"{RESULT_TAG} JSON line.")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world-size", type=int, required=True)
    ap.add_argument("--init-method", required=True,
                    help="tcp://localhost:PORT")
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    ap.add_argument("--shards", type=int, default=1)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--workload", default="flagship",
                    choices=("flagship", "parity"))
    ap.add_argument("--data-dir", required=True)
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--steps-first", type=int, default=2)
    ap.add_argument("--steps-resumed", type=int, default=4)
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    from .mesh import make_mesh

    torch.set_num_threads(THREADS)
    dist.init_process_group(args.backend, init_method=args.init_method,
                            world_size=args.world_size, rank=args.rank)
    try:
        dev = "cuda:0" if args.device == "cuda" else "cpu"
        # bring-up check: one collective on the backend's own tensors
        probe = torch.tensor([float(args.rank + 1)],
                             device=dev if args.backend == "nccl" else "cpu")
        dist.all_reduce(probe)
        env = make_mesh([dev] * args.shards)
        if args.workload == "flagship":
            res = flagship_workload(args.data_dir, args.workdir, env=env,
                                    steps_first=args.steps_first,
                                    steps_resumed=args.steps_resumed)
        else:
            res = parity_workload(args.data_dir, env)
        res["backend"] = args.backend
        res["bringup_sum"] = float(probe.item())
        res["forbidden_modules"] = forbidden_modules()
        print(RESULT_TAG + json.dumps(res), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(_worker_main())
