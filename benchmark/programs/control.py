"""The correctness control: the configuration's plain reference in
bfloat16, the nearest precision below the float32 that the
configurations state, in the program's place. The comparison has to find
it not correct; the benchmark's own runs never use it."""

from __future__ import annotations

import time

from plainref import precision
from plainref.classify import Classifier

KERNEL_ENTRIES = ()


class Program:
    def __init__(self, cfg: dict, device, timings: dict, reference):
        t0 = time.perf_counter()
        self.cfg, self.reference = cfg, reference
        self.clf = Classifier(cfg["classifier_path"], device)
        timings["classifier_s"] = time.perf_counter() - t0

    def step(self, stack) -> dict:
        out = self.reference.run(stack, self.clf, self.cfg["segmentation"],
                                 self.cfg["max_cells"], precision.BFLOAT16)
        n = out["n_cells"]
        return {"n_cells": n, "labels": out["labels"].cpu().numpy(),
                "avgint": out["avgint"][1:n + 1].cpu().numpy(),
                "code": out["code"].cpu().numpy(),
                "prob": out["prob"].cpu().numpy()}

    def free(self) -> None:
        self.clf = None


def load(cfg: dict, device, timings: dict, reference=None) -> Program:
    return Program(cfg, device, timings, reference)
