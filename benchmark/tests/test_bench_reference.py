"""The plain reference of each configuration (``benchmark/configs/
<name>.py``) against the port's step on the CPU, on a 256 x 256 px FOV of
each layout from the benchmark's scene generator: the same labels, cell
count, spectra, calls and vote fractions, so every compared number is
0."""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))

import compare  # noqa: E402
import scenes  # noqa: E402
from plainref import precision  # noqa: E402
from plainref.classify import Classifier  # noqa: E402


def _reference(config):
    spec = importlib.util.spec_from_file_location(
        "ref_" + config.replace("-", "_"), BENCH / "configs" / f"{config}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("config,traffic", [
    ("ms7b-fov2000", "confluent7b"), ("ec10b-fov2000", "confluent10b"),
    ("ec10b-fov2000", "sparse10b")])
def test_reference_equals_the_port_on_the_cpu(config, traffic):
    import importlib

    from hiprfish_tpu_torch.config import SegmentationConfig
    from hiprfish_tpu_torch.models.artifacts import load_classifier
    from hiprfish_tpu_torch.pipeline import fused

    cfg = json.loads((BENCH / "configs" / f"{config}.json").read_text())
    t = json.loads((BENCH / "traffic" / f"{traffic}.json").read_text())
    if t["geometry"] == "grid":
        t["n_cells"] = 16
    shape, max_cells = (256, 256), 256
    t["pool_size"] = 1
    stack, truth, _ = scenes.Scenes(t, cfg["layout"], shape,
                                    2**31 + 99).make(0, "cpu")
    clf_path = BENCH / "configs" / cfg["classifier"]
    mod, fn = cfg["entry"].split(":")
    step = getattr(importlib.import_module(mod), fn)
    arrays, static = fused.classifier_from_numpy(
        load_classifier(str(clf_path)), "cpu")
    res = step(stack, arrays, SegmentationConfig(**cfg["segmentation"]),
               max_cells, static, **cfg["entry_kwargs"])
    n = int(res.n_cells)
    prog = {"n_cells": n, "labels": res.segmentation.numpy(),
            "avgint": res.avgint[1:n + 1].numpy(),
            "code": res.code_idx[1:n + 1].numpy(),
            "prob": res.max_prob[1:n + 1].numpy()}
    out = _reference(config).run(stack, Classifier(str(clf_path), "cpu"),
                                 cfg["segmentation"], max_cells,
                                 precision.FLOAT32)
    assert n >= 0.8 * int(truth.max())
    assert out["n_cells"] == n
    assert np.array_equal(out["labels"].numpy(), prog["labels"])
    np.testing.assert_array_equal(out["avgint"][1:n + 1].numpy(),
                                  prog["avgint"])
    np.testing.assert_array_equal(out["code"].numpy(), prog["code"])
    ref = {k: (v.numpy() if isinstance(v, torch.Tensor) else v)
           for k, v in out.items()}
    ref["avgint"] = ref["avgint"][1:n + 1]
    got = compare.numbers(prog, ref)
    assert {k: got[k] for k in compare.NAMES} == dict.fromkeys(
        compare.NAMES, 0) | {"spectra_gap": 0.0, "vote_gap": 0.0}
    assert got["cells_identical"] == n


def test_compare_sees_a_moved_boundary_and_a_changed_call():
    labels = np.zeros((8, 8), np.int32)
    labels[1:4, 1:4] = 1
    labels[5:7, 5:7] = 2
    ref = {"n_cells": 2, "labels": labels,
           "avgint": np.array([[1.0, 0.5], [0.2, 1.0]], np.float32),
           "code": np.array([3, 4]), "prob": np.array([1.0, 0.9],
                                                      np.float32),
           "scores": np.zeros((2, 6), np.float32)}
    ref["scores"][0, 3] = 1.0
    ref["scores"][1, 4] = 0.9
    prog = dict(ref, labels=labels.copy())
    prog["labels"][4, 5] = 2                 # one pixel more in cell 2
    prog["code"] = np.array([2, 4])          # cell 1 called otherwise
    # relabelled ids do not count
    prog["labels"] = np.where(prog["labels"] > 0, 3 - prog["labels"], 0)
    prog["avgint"] = prog["avgint"][::-1].copy()
    prog["code"] = prog["code"][::-1].copy()
    prog["prob"] = prog["prob"][::-1].copy()
    got = compare.numbers(prog, ref)
    assert got["px_gap"] == 1
    assert got["cells_changed"] == 2
    assert got["cells_gap"] == 0
    assert got["cells_identical"] == 1
    assert got["spectra_gap"] == 0.0
    assert got["vote_gap"] == pytest.approx(1.0)
    # the program leaves out a cell (its pair, ref cell 1, is unmatched)
    prog["labels"] = np.where(prog["labels"] == 2, 0, prog["labels"])
    prog["n_cells"] = 1
    got = compare.numbers(prog, ref)
    assert got["px_gap"] == 9 + 1 and got["cells_gap"] == 1
    assert got["cells_changed"] == 3 and got["cells_identical"] == 0
