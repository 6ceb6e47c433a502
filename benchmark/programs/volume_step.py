"""The system under test for the 3D configurations: the port's volume
pass, ``segment3d.volume_step`` (stitch -> segment_3d_tiled -> B5 over
the channels-major slabs -> classify), driven one volume after another
by one process, each result read back to the host: n_cells, the int32
(X, Z, Y) labels, the mean spectra of cells 1..n, their calls and vote
fractions.

``load`` takes the configuration and returns the program; its ``step``
takes one ``volume7b_scenes.VolumeStack`` (it takes the tiles over) and
returns the host result. Each channel slab is rendered, when the measure
asks for it, inside ``tracing.HARNESS_RANGE``: in a deployment it would
be read from the stack's files, so the trace leaves its device work out
of every count but the busy time. ``KERNEL_ENTRIES`` names the port's
functions whose calls the traced run attributes to the hand-written
kernels (B6, B5, B3, B4), with the work each call must at least do.
"""

from __future__ import annotations

import time

import torch
from torch.profiler import record_function

import tracing
from programs.fused_step import _lookup_work, _stats_work


def _lpcv3d_work(volume, patch_size=11, theta_range=9, phi_range=9,
                 chunk_xy=128, bf16=None, layout="xyz"):
    return {"voxels": volume.numel(), "patch": patch_size,
            "theta": theta_range, "phi": phi_range}


def _stats_cm_work(labels, img_cm, num_segments, out=None):
    elem = 2 if img_cm.dtype == torch.bfloat16 else 4
    return {"pixels": labels.numel(), "ncols": 1 + img_cm.shape[0],
            "row_bytes": elem * img_cm.shape[0], "segments": num_segments}


# (module, function, kernel_work's name, work from the call's arguments,
#  whether the work counts the labelled pixels of the first argument)
KERNEL_ENTRIES = (
    ("hiprfish_tpu_torch.ops.line_profile", "lp_cv_enhance_3d", "lpcv3d",
     _lpcv3d_work, False),
    ("hiprfish_tpu_torch.ops.segstats", "stats_cm", "stats_cm",
     _stats_cm_work, True),
    ("hiprfish_tpu_torch.ops.segstats", "label_stats", "label_stats",
     _stats_work, True),
    ("hiprfish_tpu_torch.ops.segstats", "label_lookup", "label_lookup",
     _lookup_work, True),
)


class Program:
    def __init__(self, cfg: dict, device, timings: dict):
        t0 = time.perf_counter()
        # first, so that a port without the entry fails before any work
        from hiprfish_tpu_torch.pipeline.segment3d import volume_step
        from hiprfish_tpu_torch.config import SegmentationConfig
        from hiprfish_tpu_torch.models.artifacts import load_classifier
        from hiprfish_tpu_torch.pipeline import fused
        self.volume_step = volume_step
        timings["import_port_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        if device.type == "cuda":
            from hiprfish_tpu_torch.kernels import _build
            _build.load()
        timings["kernel_library_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.cfg = cfg
        self.seg_cfg = SegmentationConfig(**cfg["segmentation"])
        self.arrays, self.static = fused.classifier_from_numpy(
            load_classifier(cfg["classifier_path"]), device)
        timings["classifier_s"] = time.perf_counter() - t0

    def step(self, stack) -> dict:
        def slabs(z0, zc):
            with record_function(tracing.HARNESS_RANGE):
                return stack.slabs(z0, zc)

        res = self.volume_step(
            [stack.take_tiles()], slabs, self.arrays, self.static,
            self.seg_cfg, self.cfg["max_cells"], grid=stack.grid,
            overlap=stack.overlap, z_chunk=stack.slab_planes,
            **self.cfg["tiled"])
        n = int(res.n_cells)
        return {"n_cells": n,
                "labels": res.segmentation.cpu().numpy(),
                "avgint": res.avgint[1:n + 1].cpu().numpy(),
                "code": res.code_idx[1:n + 1].cpu().numpy(),
                "prob": res.max_prob[1:n + 1].cpu().numpy()}

    def free(self) -> None:
        """Let go of the program's device state before the check."""
        self.arrays = self.static = None


def load(cfg: dict, device, timings: dict, reference=None) -> Program:
    return Program(cfg, device, timings)
