"""The port's multi-process contract (hiprfish_tpu_torch/parallel/
distributed.py) in real processes over gloo on the CPU.

Expected: under the HIPRFISH_* contract two processes form one gloo world
(ranks 0 and 1, a sum over it of 3) and a second call returns True
without re-initialising; torchrun's variables form a world of one; with
neither contract set, initialize_from_env returns False and initialises
nothing; host_shard deals the sample list round-robin by rank (all of it
without a world); run_distributed_pipeline over four .npy samples on two
ranks writes every sample's artifacts, byte for byte those of the
one-process run_batch_pipeline, and each rank returns its own samples'
calls.
"""

import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_world
from hiprfish_tpu_torch.config import SEVEN_BIT, SegmentationConfig
from hiprfish_tpu_torch.models.artifacts import load_classifier
from hiprfish_tpu_torch.parallel import distributed, fov_batch
from hiprfish_tpu_torch.utils import synthetic

torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "torch_port_clf_7b_127x50.npz")
CFG = dict(watershed_max_iters=64, ccl_max_iters=64, kmeans_iters=10,
           lp_cell_min_size=20)
SUFFIXES = ("_avgint.csv", "_avgint_norm.csv", "_seg.npy", "_cell_ids.txt")
FOVS = [f"fov_{i}" for i in range(7)]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    root = tmp_path_factory.mktemp("dist")
    samples = []
    for i in range(4):
        fov = synthetic.make_fov(SEVEN_BIT, [1, 9, 65, 127], shape=(96, 96),
                                 seed=10 + i, cell_axes=(6.0, 9.0))
        files = []
        for laser, plane in zip(SEVEN_BIT.lasers, fov["stack"]):
            files.append(str(root / f"s{i}_{laser}.npy"))
            np.save(files[-1], plane)
        samples.append((f"s{i}", files))
    for d in ("one", "ranks"):
        (root / d).mkdir()
    want = fov_batch.run_batch_pipeline(
        samples, load_classifier(FIXTURE), SegmentationConfig(**CFG),
        max_cells=64, device="cpu", denoise=False, out_dir=str(root / "one"))
    out = torch_world.run_world(
        root / "world", 2, ["contract", "pipeline"], timeout=240,
        samples=samples, clf7_path=FIXTURE, cfg7=CFG, max_cells7=64,
        out_dir=str(root / "ranks"))
    return root, want, out


def test_hiprfish_contract_forms_gloo_world(two_ranks):
    ranks = torch_world.load(two_ranks[2], "contract", 2)
    for r, res in enumerate(ranks):
        assert str(res["backend"]) == "gloo"
        assert (int(res["rank"]), int(res["world"])) == (r, 2)
        assert float(res["sum"][0]) == 3.0
        assert bool(res["again"])


def test_host_shard_round_robin(two_ranks):
    ranks = torch_world.load(two_ranks[2], "contract", 2)
    for r, res in enumerate(ranks):
        assert list(res["shard"]) == FOVS[r::2]
    assert distributed.host_shard(FOVS) == FOVS
    assert not dist.is_initialized()


def test_torchrun_contract_forms_world_of_one(tmp_path):
    out = torch_world.run_world(tmp_path, 1, ["contract"], timeout=120,
                                torchrun=True)
    res = torch_world.load(out, "contract", 1)[0]
    assert str(res["backend"]) == "gloo"
    assert (int(res["rank"]), int(res["world"])) == (0, 1)
    assert list(res["shard"]) == FOVS


def test_no_contract_returns_false(monkeypatch):
    for k in ("HIPRFISH_COORDINATOR", "HIPRFISH_NUM_PROCESSES",
              "HIPRFISH_PROCESS_ID", "RANK", "WORLD_SIZE", "MASTER_ADDR"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.initialize_from_env() is False
    assert not dist.is_initialized()


def test_distributed_pipeline_returns_own_samples(two_ranks):
    _, want, out = two_ranks
    for r, res in enumerate(torch_world.load(out, "pipeline", 2)):
        got = json.loads(str(res["result"]))
        assert list(got) == [f"s{i}" for i in range(r, 4, 2)]
        for name, (n, codes) in got.items():
            assert (n, codes) == (want[name][0], list(want[name][1]))
            assert n >= 3


@pytest.mark.parametrize("sample", ["s0", "s1", "s2", "s3"])
def test_distributed_artifacts_equal_one_process(two_ranks, sample):
    root = two_ranks[0]
    for suffix in SUFFIXES:
        with open(root / "one" / f"{sample}{suffix}", "rb") as f:
            want = f.read()
        with open(root / "ranks" / f"{sample}{suffix}", "rb") as f:
            assert f.read() == want, suffix
