"""The ranks of the tests' torch.distributed worlds (no tests here).

``run_world`` starts one process per rank with ``python torch_world.py
JOB RANK``. Each joins the world through the port's own contract
(parallel/distributed.initialize_from_env with HIPRFISH_COORDINATOR set to
a file:// URL under the test's tmp_path, so no TCP port is taken: the
tests run under xdist; or torchrun's variables for one rank), over gloo on
the CPU, and runs the job's checks
in order, each writing its results to ``<out>/<check>.<rank>.npz`` for the
test process to compare with the JAX package. A rank imports only numpy,
torch and the port. Every process group has the job's timeout and the
launcher kills every rank that outlives its own, so a world fails, never
hangs.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from datetime import timedelta

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# torchrun's variables, which initialize_from_env reads second
_TORCHRUN = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
             "MASTER_ADDR", "MASTER_PORT")


def run_world(tmp, world: int, checks, timeout: float = 240.0,
              torchrun: bool = False, **job) -> str:
    """Run ``checks`` on ``world`` ranks; returns the output directory.
    Raises (after killing every rank) if a rank fails or the world
    outlives ``timeout`` seconds. ``torchrun``: set torchrun's variables
    instead of the HIPRFISH_* contract (one rank: its store takes a free
    port, MASTER_PORT 0)."""
    tmp = str(tmp)
    out = os.path.join(tmp, "out")
    os.makedirs(out, exist_ok=True)
    job = dict(job, world=world, checks=list(checks), out=out,
               pg_timeout=timeout / 2)
    path = os.path.join(tmp, "job.json")
    with open(path, "w") as f:
        json.dump(job, f)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("HIPRFISH_") and k not in _TORCHRUN}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    if torchrun:
        assert world == 1
        env.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                   LOCAL_WORLD_SIZE="1", MASTER_ADDR="127.0.0.1",
                   MASTER_PORT="0")
    else:
        env.update(HIPRFISH_COORDINATOR=f"file://{tmp}/pg",
                   HIPRFISH_NUM_PROCESSES=str(world))
    procs, logs = [], []
    for rank in range(world):
        log = open(os.path.join(tmp, f"rank{rank}.log"), "w")
        logs.append(log)
        rank_env = env if torchrun else dict(env,
                                             HIPRFISH_PROCESS_ID=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), path, str(rank)],
            env=rank_env, cwd=tmp, stdout=log, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        tails = []
        for r in failed:
            with open(os.path.join(tmp, f"rank{r}.log")) as f:
                tails.append(f"rank {r} (rc {procs[r].returncode}):\n"
                             + f.read()[-3000:])
        raise AssertionError("\n".join(tails))
    return out


def load(out: str, check: str, world: int) -> list:
    """Every rank's results of ``check``."""
    return [dict(np.load(os.path.join(out, f"{check}.{r}.npz"),
                         allow_pickle=False)) for r in range(world)]


# ---------------------------------------------------------------------------
# The ranks' side
# ---------------------------------------------------------------------------


def _save(job, check, me, **arrays):
    np.savez(os.path.join(job["out"], f"{check}.{me}.npz"), **arrays)


def _mesh(job):
    from hiprfish_tpu_torch.parallel import mesh as meshlib

    return meshlib.make_mesh(fov=job["fov"], tile=job["tile"],
                             device_type="cpu",
                             timeout=timedelta(seconds=job["pg_timeout"]))


def _stack(job, name):
    z = np.load(os.path.join(job["inputs"], f"{name}.npz"))
    return tuple(z[f"laser{i}"] for i in range(len(z.files)))


def check_contract(job, rank):
    """The world initialize_from_env made: backend, rank, size, a sum
    over it, and host_shard's round-robin."""
    import torch
    import torch.distributed as dist

    from hiprfish_tpu_torch.parallel import distributed

    t = torch.tensor([float(rank + 1)])
    dist.all_reduce(t)
    shard = distributed.host_shard([f"fov_{i}" for i in range(7)])
    _save(job, "contract", rank, backend=str(dist.get_backend()),
          rank=dist.get_rank(), world=dist.get_world_size(),
          sum=t.numpy(), shard=np.array(shard),
          again=distributed.initialize_from_env())


def check_lpcv(job, rank):
    """lp_cv_enhance_2d_sharded over each mesh dim with more than one
    rank."""
    from hiprfish_tpu_torch.parallel import mesh as meshlib, spatial

    mesh = _mesh(job)
    img = np.load(os.path.join(job["inputs"], "img.npy"))
    res = {}
    for axis in ("fov", "tile"):
        if meshlib.dim_size(mesh, axis) > 1:
            res[axis] = spatial.lp_cv_enhance_2d_sharded(
                img, mesh, axis).numpy()
    _save(job, "lpcv", rank, **res)


def check_fov_step(job, rank):
    from hiprfish_tpu_torch.config import SegmentationConfig
    from hiprfish_tpu_torch.models.artifacts import load_classifier
    from hiprfish_tpu_torch.parallel import fov_batch
    from hiprfish_tpu_torch.pipeline import fused

    arrays, static = fused.classifier_from_numpy(
        load_classifier(os.path.join(job["inputs"], "clf7.npz")), "cpu")
    run = fov_batch.batched_fov_step(
        _mesh(job), SegmentationConfig(**job["cfg7"]), job["max_cells7"],
        static, denoise=False)
    stack = _stack(job, "stack7")
    out = run(stack, arrays)
    try:
        run(tuple(s[:3] for s in stack), arrays)
        ragged = ""
    except ValueError as e:
        ragged = str(e)
    _save(job, "fov_step", rank, seg=out.segmentation.numpy(),
          n_cells=out.n_cells.numpy(), code_idx=out.code_idx.numpy(),
          valid=out.valid.numpy(), ragged=ragged)


def check_ecoli(job, rank):
    from hiprfish_tpu_torch.config import SegmentationConfig
    from hiprfish_tpu_torch.models.artifacts import load_classifier
    from hiprfish_tpu_torch.parallel import fov_batch
    from hiprfish_tpu_torch.pipeline import fused

    arrays, static = fused.classifier_from_numpy(
        load_classifier(job["clf10"]), "cpu")
    run = fov_batch.batched_fov_step_ecoli(
        _mesh(job), SegmentationConfig(**job["cfg10"]), job["max_cells10"],
        static, classify_cap=job["max_cells10"])
    seg, n, _, code_idx, _ = run(_stack(job, "stack10"), arrays)
    _save(job, "ecoli", rank, seg=seg.numpy(), n_cells=n.numpy(),
          code_idx=code_idx.numpy())


def check_train(job, rank):
    """train_check_heads_dp for 20 and 200 steps, and the one-process
    trainer (classifier.train_check_heads, one head whose batch is all
    the rows) for 20."""
    import torch

    from hiprfish_tpu_torch.models import classifier
    from hiprfish_tpu_torch.parallel import fov_batch

    z = np.load(os.path.join(job["inputs"], "train.npz"))
    x, y = z["x"], z["y"]
    init = {k: z[k] for k in ("w1", "b1", "w2", "b2")}
    mesh = _mesh(job)
    dp20 = fov_batch.train_check_heads_dp(mesh, x, y, init, 20, 3e-3)
    dp200 = fov_batch.train_check_heads_dp(mesh, x, y, init, 200, 3e-3)
    one = classifier.train_check_heads(
        torch.from_numpy(x)[None], torch.from_numpy(y)[None],
        {k: torch.from_numpy(v)[None] for k, v in init.items()},
        torch.arange(x.shape[0])[None], 20, 3e-3)
    _save(job, "train", rank,
          **{f"dp20_{k}": v for k, v in dp20.items()},
          **{f"dp200_{k}": v for k, v in dp200.items()},
          **{f"one20_{k}": v[0].numpy() for k, v in one.items()})


def check_seg3d(job, rank):
    import torch

    from hiprfish_tpu_torch.config import SegmentationConfig
    from hiprfish_tpu_torch.pipeline import segment3d

    vol = np.load(os.path.join(job["inputs"], "vol3d.npy"))
    mesh = _mesh(job)
    seg, n, _ = segment3d.segment_3d_tiled(
        torch.from_numpy(vol), SegmentationConfig(), mesh=mesh,
        **job["tiled"])
    # each tile seeding its own slab (the replayed last slab too)
    seg_in, n_in, _ = segment3d.segment_3d_tiled(
        torch.from_numpy(vol), SegmentationConfig(), mesh=mesh,
        global_seeds=False, **job["tiled"])
    _save(job, "seg3d", rank, seg=seg.numpy(), n_cells=np.int64(n),
          seg_in_tile=seg_in.numpy(), n_in_tile=np.int64(n_in))


def check_zsharded(job, rank):
    """measure_volume_zsharded, and its ragged-Z refusal."""
    from hiprfish_tpu_torch.pipeline import segment3d

    z = np.load(os.path.join(job["inputs"], "zsharded.npz"))
    mesh = _mesh(job)
    got = segment3d.measure_volume_zsharded(z["seg"], z["vol_cm"], mesh,
                                            "fov", 16)
    try:
        segment3d.measure_volume_zsharded(
            np.zeros((8, 8, 9), np.int32), np.zeros((2, 9, 8, 8)), mesh,
            max_cells=4)
        ragged = ""
    except ValueError as e:
        ragged = str(e)
    _save(job, "zsharded", rank, spectra=got.numpy(), ragged=ragged)


def check_oom_batch(job, rank):
    """run_batch_pipeline over the mesh with one torch.OutOfMemoryError
    injected into the first fov_step of rank ``oom_rank``."""
    import torch

    from hiprfish_tpu_torch.config import SegmentationConfig
    from hiprfish_tpu_torch.models.artifacts import load_classifier
    from hiprfish_tpu_torch.parallel import fov_batch
    from hiprfish_tpu_torch.pipeline import fused

    real = fused.fov_step
    calls = []

    def flaky(*a, **kw):
        calls.append(len(calls))
        if rank == job["oom_rank"] and len(calls) == 1:
            raise torch.OutOfMemoryError("injected: CUDA out of memory")
        return real(*a, **kw)

    fused.fov_step = flaky
    res = fov_batch.run_batch_pipeline(
        [tuple(s) for s in job["samples"]],
        load_classifier(job["clf7_path"]), SegmentationConfig(**job["cfg7"]),
        max_cells=job["max_cells7"], batch=job["batch"], mesh=_mesh(job),
        denoise=False, out_dir=job["out_dir"])
    fused.fov_step = real
    _save(job, "oom_batch", rank, calls=np.int64(len(calls)),
          result=json.dumps(res))


def check_pipeline(job, rank):
    """run_distributed_pipeline on the CPU over the job's samples."""
    from hiprfish_tpu_torch.config import SegmentationConfig
    from hiprfish_tpu_torch.models.artifacts import load_classifier
    from hiprfish_tpu_torch.parallel import distributed

    res = distributed.run_distributed_pipeline(
        [tuple(s) for s in job["samples"]],
        load_classifier(job["clf7_path"]), SegmentationConfig(**job["cfg7"]),
        max_cells=job["max_cells7"], out_dir=job["out_dir"], denoise=False,
        device="cpu")
    _save(job, "pipeline", rank, result=json.dumps(res))


def main(path: str, rank: int) -> None:
    # a rank runs the port alone: any import of the JAX package fails
    sys.modules["jax"] = None
    sys.modules["hiprfish_tpu"] = None
    import torch
    import torch.distributed as dist

    from hiprfish_tpu_torch.parallel import distributed

    torch.set_num_threads(1)
    with open(path) as f:
        job = json.load(f)
    if not distributed.initialize_from_env(
            timedelta(seconds=job["pg_timeout"])):
        raise RuntimeError("no contract was read")
    for name in job["checks"]:
        globals()[f"check_{name}"](job, rank)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
