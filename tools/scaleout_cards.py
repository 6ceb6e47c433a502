#!/usr/bin/env python3
"""chip_smoke.py's phase 21 checks on every card of one host, one rank per
card over NCCL:

    torchrun --nproc_per_node=N tools/scaleout_cards.py

Each rank joins through parallel/distributed.initialize_from_env
(torchrun's variables; NCCL, since every rank has a card of its own).
Rank 0 builds the kernels, writes the 2000^2 7-bit and 10-bit FOVs' planes
and the one-card references (their single-FOV steps, then
chip_smoke._scale_inputs) to a directory under the working directory;
then every rank runs chip_smoke._scale_checks over ('fov' = N) and
('tile' = N) meshes with N copies of each FOV per batch, and rank 0
prints each path's seconds, ms per FOV and launches, the slowest rank's,
and the card's name and power limit. Any disagreement raises on its rank,
and the run exits non-zero.
"""

from __future__ import annotations

import os
import shutil
import sys
import time
from datetime import timedelta

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402


def _prepare(torch, kernels, work: str, dev) -> None:
    """Rank 0: the planes and every reference into ``work``."""
    from hiprfish_tpu_torch.config import SegmentationConfig
    from hiprfish_tpu_torch.models.artifacts import load_classifier
    from hiprfish_tpu_torch.pipeline import fused, fused_ecoli
    from hiprfish_tpu_torch.utils import synthetic

    refs = {}
    for tag, make, lasers, name, clf_path, step in (
            ("ref5", synthetic.flagship_fov, cs.LASERS_7B, "flagship",
             cs.FIXTURE, fused.fov_step),
            ("ref11", synthetic.ecoli_fov, cs.LASERS_10B, "ecoli_enc_5",
             cs.FIXTURE_10B, fused_ecoli.fov_step_ecoli)):
        fov = make()
        for laser, plane in zip(lasers, fov["stack"]):
            np.save(os.path.join(work, f"{name}_{laser}.npy"), plane)
        arrays, static = fused.classifier_from_numpy(
            load_classifier(clf_path), dev)
        res = step(tuple(torch.from_numpy(a).to(dev) for a in fov["stack"]),
                   arrays, SegmentationConfig(), cs.MAX_CELLS, static)
        n = int(res.n_cells)
        refs.update({f"{tag}_seg": res.segmentation.cpu().numpy(),
                     f"{tag}_n": np.int64(n),
                     f"{tag}_codes": res.code_idx[1:n + 1].cpu().numpy()})
    cs._scale_inputs(torch, kernels, dev, refs, work)


def main() -> int:
    import torch
    import torch.distributed as dist

    from hiprfish_tpu_torch import kernels
    from hiprfish_tpu_torch.kernels import _build
    from hiprfish_tpu_torch.parallel import distributed
    from hiprfish_tpu_torch.parallel import mesh as meshlib

    timeout = timedelta(seconds=cs.SCALE_TIMEOUT_S)
    if not distributed.initialize_from_env(timeout):
        print("run under torchrun", file=sys.stderr)
        return 2
    rank, world = dist.get_rank(), dist.get_world_size()
    dev = torch.device("cuda", torch.cuda.current_device())
    work = os.path.abspath("scaleout_cards_work")
    t0 = time.time()
    if rank == 0:
        shutil.rmtree(work, ignore_errors=True)
        os.makedirs(work)
        _build.build()
        _prepare(torch, kernels, work, dev)
        print(f"rank 0 prepared in {time.time() - t0:.1f} s "
              f"({dist.get_backend()}, world {world})", flush=True)
    dist.barrier()
    try:
        mesh_f = meshlib.make_mesh(fov=world, tile=1, timeout=timeout)
        mesh_t = meshlib.make_mesh(fov=1, tile=world, timeout=timeout)
        inp = dict(np.load(os.path.join(work, "inputs.npz")))
        out = cs._scale_checks(torch, kernels, mesh_f, mesh_t, work, inp,
                               copies=world)
        every = meshlib.all_gather_object(out, mesh_f)
        if rank == 0:
            print(cs._card_line())
            for name, r in out.items():
                slow = max(o[name]["seconds warm"] for o in every)
                print(f"{name}: rank 0 {r['seconds']:.3f} s cold, "
                      f"{r['seconds warm']:.3f} s warm (slowest rank "
                      f"{slow:.3f})"
                      + (f", {r['ms_per_fov warm']:.1f} ms/FOV warm"
                         if "ms_per_fov warm" in r else "")
                      + (f", max_abs_err {r['max_abs_err']:.3e}"
                         if "max_abs_err" in r else "")
                      + f"; launches {r['launches']}")
            print(f"all {world} ranks agree with the one-card results; "
                  f"{time.time() - t0:.1f} s")
    finally:
        dist.barrier()
        if rank == 0:
            shutil.rmtree(work, ignore_errors=True)
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
