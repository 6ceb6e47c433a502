"""The system under test for the 2D configurations: the port's fused
per-FOV step (``entry`` in the configuration, ``fov_step`` or
``fov_step_ecoli``), driven as ``parallel/fov_batch.run_batch_pipeline``'s
one-card sweep drives it: one FOV after another, each result read back to
the host (``_host``: n_cells, the int32 labels, the mean spectra of cells
1..n, the barcodes; and the vote fractions).

``load`` takes the configuration and returns the program; its ``step``
takes one FOV's per-laser planes on the device and returns the host
result. ``KERNEL_ENTRIES`` names the port's functions whose calls the
traced run attributes to the hand-written kernels, with the work each
call must at least do (``kernel_work``'s arguments).
"""

from __future__ import annotations

import importlib
import time

import torch


def _nlm_work(image, h=0.02, patch_size=7, patch_distance=11):
    return {"h": image.shape[0], "w": image.shape[1], "pd": patch_distance}


def _lpcv_work(image, patch_size=11, phi_range=9):
    return {"h": image.shape[0], "w": image.shape[1], "patch": patch_size,
            "phi": phi_range}


def _stats_work(labels, image, num_segments, aux=None, aux_classes=0,
                moments=False, image_mask=None):
    nchan = 0 if image is None else image.shape[-1]
    elem = 2 if image is not None and image.dtype == torch.bfloat16 else 4
    ncols = (2 + (5 if moments else 0) + nchan
             + (aux_classes if aux is not None else 0)
             + (1 if image_mask is not None else 0))
    return {"pixels": labels.numel(), "ncols": ncols,
            "row_bytes": elem * nchan,
            "px_bytes": 4 * (aux is not None) + 4 * (image_mask is not None),
            "segments": num_segments}


def _lookup_work(labels, table, out_dtype=None):
    return {"pixels": labels.numel(), "segments": table.numel()}


# (module, function, kernel_work's name, work from the call's arguments,
#  whether the work counts the labelled pixels of the first argument)
KERNEL_ENTRIES = (
    ("hiprfish_tpu_torch.ops.denoise", "denoise_nl_means", "nlm",
     _nlm_work, False),
    ("hiprfish_tpu_torch.ops.line_profile", "lp_cv_enhance_2d", "lpcv2d",
     _lpcv_work, False),
    ("hiprfish_tpu_torch.ops.segstats", "label_stats", "label_stats",
     _stats_work, True),
    ("hiprfish_tpu_torch.ops.segstats", "label_lookup", "label_lookup",
     _lookup_work, True),
)


class Program:
    def __init__(self, cfg: dict, device, timings: dict):
        t0 = time.perf_counter()
        mod_name, fn_name = cfg["entry"].split(":")
        self.entry = getattr(importlib.import_module(mod_name), fn_name)
        from hiprfish_tpu_torch.config import SegmentationConfig
        from hiprfish_tpu_torch.models.artifacts import load_classifier
        from hiprfish_tpu_torch.pipeline import fused
        timings["import_port_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        if device.type == "cuda":
            from hiprfish_tpu_torch.kernels import _build
            _build.load()
        timings["kernel_library_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.cfg = cfg
        self.seg_cfg = SegmentationConfig(**cfg["segmentation"])
        clf = load_classifier(cfg["classifier_path"])
        self.codebook = clf.codebook
        self.arrays, self.static = fused.classifier_from_numpy(clf, device)
        timings["classifier_s"] = time.perf_counter() - t0

    def step(self, stack) -> dict:
        res = self.entry(stack, self.arrays, self.seg_cfg,
                         self.cfg["max_cells"], self.static,
                         **self.cfg["entry_kwargs"])
        n = int(res.n_cells)
        host = {"n_cells": n,
                "labels": res.segmentation.cpu().numpy(),
                "avgint": res.avgint[1:n + 1].cpu().numpy(),
                "code": res.code_idx[1:n + 1].cpu().numpy(),
                "prob": res.max_prob[1:n + 1].cpu().numpy()}
        host["barcodes"] = [self.codebook[c] for c in host["code"].tolist()]
        return host

    def free(self) -> None:
        """Let go of the program's device state before the check."""
        self.arrays = self.static = None


def load(cfg: dict, device, timings: dict, reference=None) -> Program:
    return Program(cfg, device, timings)
