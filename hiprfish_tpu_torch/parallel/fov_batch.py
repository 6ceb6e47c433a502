"""FOV batches over the mesh (the port of
hiprfish_tpu/parallel/fov_batch.py).

The JAX module shards a batch of FOVs over the mesh's 'fov' axis with
``shard_map``: each device sweeps its block of the batch through the
single-FOV program under ``lax.map``, and the outputs form one global
array. The port runs one process per card: each rank of a 'fov' group
moves its contiguous block of the batch (``P("fov")`` is block sharding)
to its own card and sweeps it through ``fused.fov_step`` or
``fused_ecoli.fov_step_ecoli`` (kernels B1-B4); ranks along 'tile' repeat
that work, as ``P("fov")`` replicates it there; the outputs are
all-gathered, so every rank holds the whole batch's result, as the JAX
function returns it.

``run_batch_pipeline`` is the production runner: without a mesh, the
one-card sweep (the prefetching loader stages the next FOVs while the card
runs the current one); with one, every rank decodes, stages and writes
only its own FOVs of each batch, and a device out-of-memory error halves
the batch on every rank (the ranks first agree on it). The data-parallel
check-head step ``train_check_heads_dp`` all-reduces its gradients over
'fov'.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from hiprfish_tpu_torch.config import SegmentationConfig
from hiprfish_tpu_torch.io import outputs
from hiprfish_tpu_torch.io.loader import FovPrefetcher
from hiprfish_tpu_torch.models import classifier
from hiprfish_tpu_torch.parallel import mesh as meshlib
from hiprfish_tpu_torch.pipeline import fused, fused_ecoli
from hiprfish_tpu_torch.utils import oom


def _own_rows(mesh, b: int) -> range:
    """This rank's contiguous block of a batch of ``b`` sharded over
    'fov'; raises unless b divides by the dim's size."""
    n_fov = meshlib.dim_size(mesh, "fov")
    if b % n_fov:
        raise ValueError(f"batch {b} must divide by mesh['fov']={n_fov}")
    per = b // n_fov
    lo = mesh.get_local_rank("fov") * per
    return range(lo, lo + per)


def _sweep(mesh, step):
    """call(stack, clf_arrays) -> the gathered columns of ``step`` over
    this rank's block of the batch."""
    def call(stack, clf_arrays):
        rows = _own_rows(mesh, len(stack[0]))
        dev = meshlib.mesh_device(mesh)
        outs = [step(tuple(torch.as_tensor(s[i]).to(dev) for s in stack),
                     clf_arrays) for i in rows]
        return [meshlib.all_gather_rows(torch.stack(col), mesh)
                for col in zip(*outs)]

    return call


def batched_fov_step(mesh, cfg: SegmentationConfig, max_cells: int,
                     clf_static, denoise: bool = True):
    """Batched 7-bit step: returns call(stack, clf_arrays) -> FovResult
    with leading batch dims, stack a tuple of (B, H, W, C_l) per-laser
    arrays or tensors, or of per-laser sequences of B (H, W, C_l) planes
    (the same global batch on every rank), clf_arrays from
    fused.classifier_from_numpy on this rank's device. B must be a
    multiple of the mesh's 'fov' size; each rank sweeps its block at
    single-FOV speed."""
    run = _sweep(mesh, lambda st, arrays: fused.fov_step(
        st, arrays, cfg, max_cells, clf_static, denoise))
    return lambda stack, clf_arrays: fused.FovResult(*run(stack, clf_arrays))


def batched_fov_step_ecoli(mesh, cfg: SegmentationConfig, max_cells: int,
                           clf_static, classify_cap: int = 2048):
    """10-bit counterpart of batched_fov_step over
    fused_ecoli.fov_step_ecoli. Returns call(stack, clf_arrays) -> (seg,
    n_cells, avgint_norm, code_idx, max_prob), leading batch dims, as the
    JAX function does."""
    def step(st, arrays):
        r = fused_ecoli.fov_step_ecoli(st, arrays, cfg, max_cells,
                                       clf_static, classify_cap)
        return r.segmentation, r.n_cells, r.avgint_norm, r.code_idx, \
            r.max_prob

    return lambda stack, clf_arrays: tuple(_sweep(mesh, step)(stack,
                                                              clf_arrays))


def _save(out_dir: str, name: str, seg, avgint, norm, codes) -> None:
    """The reference's per-FOV artifacts: {name}_avgint.csv,
    _avgint_norm.csv (with header), _seg.npy and _cell_ids.txt."""
    prefix = os.path.join(out_dir, name)
    outputs.save_avgint_csv(prefix + "_avgint.csv", avgint)
    outputs.save_avgint_norm_csv_with_header(prefix + "_avgint_norm.csv",
                                             norm)
    np.save(prefix + "_seg.npy", seg)
    outputs.save_cell_ids(prefix + "_cell_ids.txt", codes)


def _host(res, clf):
    """One fov_step result on the host: (n_cells, labels, then avgint,
    avgint_norm and barcodes of cells 1..n_cells)."""
    n = int(res.n_cells)
    return (n, res.segmentation.cpu().numpy(),
            res.avgint[1:n + 1].cpu().numpy(),
            res.avgint_norm[1:n + 1].cpu().numpy(),
            [clf.codebook[int(c)]
             for c in res.code_idx[1:n + 1].cpu().numpy()])


def run_batch_pipeline(samples, clf, cfg: SegmentationConfig | None = None,
                       max_cells: int = 4096, batch: int | None = None,
                       device=torch.device("cuda"), denoise: bool = True,
                       out_dir: str = ".", timings=None, mesh=None):
    """Prefetch-decode FOVs, run the fused 7-bit step on each, write the
    reference-format artifacts.

    Args:
      samples: list of (sample_name, [per-laser filenames]).
      clf: a models/artifacts ClassifierArrays.
      batch: the FOVs of one batch (the mesh's 'fov' size when None, 1
        without a mesh); without a mesh the loader reads batch + 1 ahead.
      device: where the one-card sweep runs (the card unless the caller
        names the CPU); the loader stages the planes there. With a mesh,
        each rank works on the mesh's device instead.
      timings: a dict that receives {name: {"decode": worker seconds,
        "step": seconds of fov_step, synchronised}} (with a mesh, of this
        rank's FOVs).
      mesh: a parallel/mesh ('fov', 'tile') DeviceMesh. Each batch, padded
        with its last FOV, is block-sharded over 'fov': every rank decodes
        and stages only its own FOVs, and the 'tile' rank 0 of each block
        writes their artifacts. A device out-of-memory error on any rank
        makes every rank run the batch as two halves of b // 2 while
        b // 2 >= fov and the halves still divide by it.
    Writes {name}_avgint.csv, _avgint_norm.csv (with header), _seg.npy and
    _cell_ids.txt into ``out_dir``. Returns {name: (n_cells, barcode
    list)} (with a mesh, of every rank's FOVs, on every rank).
    """
    cfg = cfg or SegmentationConfig()
    if mesh is not None:
        return _run_mesh(samples, clf, cfg, max_cells, batch, mesh, denoise,
                         out_dir, timings)
    device = torch.device(device)
    batch = batch or 1
    arrays, static = fused.classifier_from_numpy(clf, device)
    results = {}
    with FovPrefetcher(samples, depth=batch + 1, device=device) as loader:
        for name, stack in loader:
            t0 = time.perf_counter()
            res = fused.fov_step(tuple(stack), arrays, cfg, max_cells,
                                 static, denoise)
            n, seg, avgint, norm, codes = _host(res, clf)
            if timings is not None:
                timings[name] = {"decode": loader.decode_seconds[name],
                                 "step": time.perf_counter() - t0}
            del stack, res
            _save(out_dir, name, seg, avgint, norm, codes)
            results[name] = (n, codes)
    return results


def _run_mesh(samples, clf, cfg, max_cells, batch, mesh, denoise, out_dir,
              timings):
    """run_batch_pipeline over a mesh (see there)."""
    n_fov = meshlib.dim_size(mesh, "fov")
    batch = batch or n_fov
    own = _own_rows(mesh, batch)
    writer = mesh.get_local_rank("tile") == 0
    dev = meshlib.mesh_device(mesh)
    arrays, static = fused.classifier_from_numpy(clf, dev)
    samples = list(samples)
    # this rank's rows of every padded batch: (sample, real FOV or pad)
    batches = []
    for b0 in range(0, len(samples), batch):
        chunk = samples[b0:b0 + batch]
        real = len(chunk)
        chunk = chunk + [chunk[-1]] * (batch - real)
        batches.append([(chunk[i], i < real) for i in own])

    def step(stacks):
        """Stage the rows on the card, run fov_step on each; the outputs
        are read back as each row finishes. The staged rows stay alive to
        the end, as a batch's inputs do."""
        staged = [tuple(torch.from_numpy(np.ascontiguousarray(a, np.float32))
                        .to(dev) for a in st) for st in stacks]
        outs = []
        for st in staged:
            t0 = time.perf_counter()
            res = fused.fov_step(st, arrays, cfg, max_cells, static, denoise)
            outs.append((*_host(res, clf), time.perf_counter() - t0))
        return outs

    def run(stacks, b: int) -> list:
        """step() under the mesh's verdict: every rank reports 0 (done),
        1 (device out of memory) or 2 (another error), and all act on the
        worst, so no rank is left waiting in a collective the others
        skip."""
        status, err, outs = 0, None, None
        try:
            outs = step(stacks)
        except Exception as e:  # noqa: BLE001 - reported to every rank
            status = 1 if oom.is_oom_error(e) else 2
            # an OOM's traceback would hold the failed attempt's tensors
            err = e.with_traceback(None) if status == 1 else e
        worst = int(meshlib.all_reduce(
            torch.tensor([float(status)], device=dev), mesh, ("fov", "tile"),
            dist.ReduceOp.MAX))
        if worst == 0:
            return outs
        if status == 2:
            raise err
        if worst == 2:
            raise RuntimeError("run_batch_pipeline: another rank of the "
                               "mesh failed")
        half = b // 2
        if half < n_fov or b % 2 or half % n_fov:
            raise err or RuntimeError(f"device out of memory on another "
                                      f"rank at batch={b}")
        oom.log.warning("device OOM at batch=%d, retrying as 2 x %d", b, half)
        outs = err = None
        oom.empty_cache()
        k = len(stacks) // 2
        return run(stacks[:k], half) + run(stacks[k:], half)

    results = {}
    rows = [(name, files) for rows_b in batches for (name, files), _ in rows_b]
    with FovPrefetcher(rows, depth=len(own) + 1) as loader:
        it = iter(loader)
        for rows_b in batches:
            stacks = [next(it)[1] for _ in rows_b]
            outs = run(stacks, batch)
            del stacks
            for ((name, _), real), (n, seg, avgint, norm, codes, step_s) \
                    in zip(rows_b, outs):
                if not real:
                    continue
                if timings is not None:
                    timings[name] = {"decode": loader.decode_seconds[name],
                                     "step": step_s}
                if writer:
                    _save(out_dir, name, seg, avgint, norm, codes)
                results[name] = (n, codes)
    merged = {}
    for part in meshlib.all_gather_object(results, mesh):
        merged.update(part)
    return {name: merged[name] for name, _ in samples if name in merged}


def train_check_heads_dp(mesh, x, y, init_params, steps: int, lr: float):
    """Data-parallel check-head training: the rows of x (n, d_in) and y
    (n,) are block-sharded over 'fov', every step takes the mean binary
    cross-entropy of the rank's whole shard, and the gradients are
    all-reduced and divided by the 'fov' size (the JAX function's
    lax.pmean) before Adam(lr, (0.9, 0.999), 1e-8) steps, as in
    models/classifier.train_check_heads. ``init_params`` is the
    reference's {w1 (d_in, hidden), b1, w2 (hidden, 1), b2} numpy dict,
    loaded through CheckHead.from_numpy; every rank returns the same
    trained parameters in that form."""
    n_fov = meshlib.dim_size(mesh, "fov")
    rows = _own_rows(mesh, x.shape[0])
    dev = meshlib.mesh_device(mesh)
    xb = torch.as_tensor(x[rows.start:rows.stop]).to(dev, torch.float32)
    yb = torch.as_tensor(y[rows.start:rows.stop]).to(dev, torch.float32)
    head = classifier.CheckHead.from_numpy(init_params, dev) \
        .requires_grad_(True).train()
    params = list(head.parameters())
    opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                           weight_decay=0.0, foreach=True, fused=False)
    for _ in range(steps):
        loss = F.binary_cross_entropy_with_logits(head(xb), yb)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        flat = torch.cat([p.grad.reshape(-1) for p in params])
        meshlib.all_reduce(flat, mesh).div_(n_fov)
        for p, g in zip(params, torch.split(flat, [p.numel()
                                                   for p in params])):
            p.grad.copy_(g.view_as(p))
        opt.step()
    return {"w1": head.fc1.weight.detach().T.cpu().numpy().copy(),
            "b1": head.fc1.bias.detach().cpu().numpy().copy(),
            "w2": head.fc2.weight.detach().T.cpu().numpy().copy(),
            "b2": head.fc2.bias.detach().cpu().numpy().copy()}
