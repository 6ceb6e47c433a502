"""Port parity for the out-of-memory recovery (hiprfish_tpu_torch/utils/
oom.py) and its two users: the z_chunk ladder of
pipeline/segment3d.measure_volume_streamed and the batch halving of
parallel/fov_batch.run_batch_pipeline over a mesh.

Expected: is_oom_error, halving_ladder and run_with_backoff answer as the
JAX ones on the same inputs, and is_oom_error is true for a
torch.OutOfMemoryError of any message; the streamed measurement walks
4 -> 2 -> 1 in both layouts (tests/test_oom_backoff.py's walk) and gives
the plain per-label means (rtol 1e-5, the JAX test's tolerance) and the
JAX function's labels >= 1; in a gloo world of two ranks, an injected
torch.OutOfMemoryError on rank 1 only makes both ranks run the batch of
four as two halves of two, and every artifact equals the one-card
sweep's byte for byte.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_world
from hiprfish_tpu.pipeline import segment3d as jsegment3d
from hiprfish_tpu.utils import oom as joom
from hiprfish_tpu_torch.config import SEVEN_BIT, SegmentationConfig
from hiprfish_tpu_torch.models.artifacts import load_classifier
from hiprfish_tpu_torch.parallel import fov_batch
from hiprfish_tpu_torch.pipeline import segment3d
from hiprfish_tpu_torch.utils import oom, synthetic

torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "torch_port_clf_7b_127x50.npz")
CFG = dict(watershed_max_iters=64, ccl_max_iters=64, kmeans_iters=10,
           lp_cell_min_size=20)
SUFFIXES = ("_avgint.csv", "_avgint_norm.csv", "_seg.npy", "_cell_ids.txt")


class FakeOom(RuntimeError):
    def __str__(self):
        return "RESOURCE_EXHAUSTED: TPU backend error (ResourceExhausted)."


MESSAGES = ["RESOURCE_EXHAUSTED: foo", "Out of memory allocating 1g",
            "invalid argument", "OOM when allocating tensor",
            "INTERNAL: Ran out of memory in memory space hbm",
            "Allocation of 4 GiB would exceed memory",
            "Program exceeded HBM capacity", "ResourceExhausted",
            "CUDA out of memory. Tried to allocate 2.00 GiB", "boom"]


@pytest.mark.parametrize("message", MESSAGES)
def test_is_oom_error_matches_jax(message):
    e = RuntimeError(message)
    assert oom.is_oom_error(e) == joom.is_oom_error(e)


def test_is_oom_error_takes_torch_oom():
    assert oom.is_oom_error(torch.OutOfMemoryError())
    assert oom.is_oom_error(torch.cuda.OutOfMemoryError("no text"))
    assert oom.is_oom_error(FakeOom()) and joom.is_oom_error(FakeOom())
    assert not oom.is_oom_error(ValueError("real bug"))


@pytest.mark.parametrize("start,floor", [(128, 32), (100, 32), (16, 32),
                                         (4, 1), (5, 1), (1, 1)])
def test_halving_ladder_matches_jax(start, floor):
    assert list(oom.halving_ladder(start, floor)) \
        == list(joom.halving_ladder(start, floor))


def _backoff(lib, exc):
    calls, retries = [], []

    def fn(size):
        calls.append(size)
        if size > 32:
            raise exc()
        return size * 2

    out = lib.run_with_backoff(fn, lib.halving_ladder(128, 16),
                               on_retry=lambda s, n: retries.append((s, n)))
    return out, calls, retries


def test_run_with_backoff_matches_jax():
    want = _backoff(joom, FakeOom)
    assert want == ((64, 32), [128, 64, 32], [(128, 64), (64, 32)])
    assert _backoff(oom, FakeOom) == want
    assert _backoff(oom, torch.OutOfMemoryError) == want


def test_run_with_backoff_propagates_and_exhausts():
    def bug(size):
        raise ValueError("real bug")

    def full(size):
        raise torch.OutOfMemoryError(f"at {size}")

    with pytest.raises(ValueError, match="real bug"):
        oom.run_with_backoff(bug, [128, 64])
    with pytest.raises(torch.OutOfMemoryError, match="at 4"):
        oom.run_with_backoff(full, [8, 4])
    with pytest.raises(ValueError, match="empty"):
        oom.run_with_backoff(bug, [])


@pytest.mark.parametrize("channels_major", [False, True])
def test_measure_streamed_walks_z_chunk_ladder(channels_major):
    rng = np.random.RandomState(0)
    x = y = 16
    z, c, max_cells = 5, 3, 8
    seg = rng.randint(0, max_cells, (x, y, z)).astype(np.int32)
    vol = rng.rand(x, y, z, c).astype(np.float32)
    vol_cm = np.ascontiguousarray(vol.transpose(3, 2, 0, 1))

    def loader(exc, wrap, calls):
        def load(z0, zc):
            calls.append(zc)
            if zc > 1:
                raise exc()
            return wrap(vol_cm[:, z0:z0 + zc] if channels_major
                        else vol[:, :, z0:z0 + zc])
        return load

    calls_t, calls_j = [], []
    got = segment3d.measure_volume_streamed(
        torch.from_numpy(seg), loader(torch.OutOfMemoryError,
                                      torch.from_numpy, calls_t),
        z, 4, c, max_cells, channels_major=channels_major).numpy()
    want_j = np.asarray(jsegment3d.measure_volume_streamed(
        jnp.asarray(seg), loader(FakeOom, jnp.asarray, calls_j), z, 4, c,
        max_cells, channels_major=channels_major))
    assert calls_t[:2] == [4, 2] and calls_t[2:] == [1] * z
    assert calls_t == calls_j
    want = np.zeros((max_cells, c), np.float32)
    for lbl in range(1, max_cells):
        m = seg == lbl
        if m.any():
            want[lbl] = vol[m].mean(axis=0)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[1:], want_j[1:], rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def halved(tmp_path_factory):
    """Four 96^2 FOVs through the one-card sweep and through a world of
    two ranks at batch 4 with an OOM injected on rank 1."""
    root = tmp_path_factory.mktemp("oom")
    samples = []
    for i in range(4):
        fov = synthetic.make_fov(SEVEN_BIT, [1, 9, 65, 127], shape=(96, 96),
                                 seed=i, cell_axes=(6.0, 9.0))
        files = []
        for laser, plane in zip(SEVEN_BIT.lasers, fov["stack"]):
            files.append(str(root / f"s{i}_{laser}.npy"))
            np.save(files[-1], plane)
        samples.append((f"s{i}", files))
    for d in ("one", "mesh"):
        (root / d).mkdir()
    want = fov_batch.run_batch_pipeline(
        samples, load_classifier(FIXTURE), SegmentationConfig(**CFG),
        max_cells=64, device="cpu", denoise=False, out_dir=str(root / "one"))
    out = torch_world.run_world(
        root / "world", 2, ["oom_batch"], timeout=240, fov=2, tile=1,
        samples=samples, clf7_path=FIXTURE, cfg7=CFG, max_cells7=64,
        batch=4, oom_rank=1, out_dir=str(root / "mesh"))
    return root, want, torch_world.load(out, "oom_batch", 2)


def test_batch_oom_halves_on_every_rank(halved):
    _, want, ranks = halved
    # rank 0: two FOVs, then one per half; rank 1: the injected OOM, then
    # one per half
    assert [int(r["calls"]) for r in ranks] == [4, 3]
    import json

    for r in ranks:
        got = json.loads(str(r["result"]))
        assert list(got) == list(want)
        assert {k: tuple(v) for k, v in got.items()} == \
            {k: (n, list(c)) for k, (n, c) in want.items()}
        assert all(n >= 3 for n, _ in want.values())


@pytest.mark.parametrize("sample", ["s0", "s1", "s2", "s3"])
def test_batch_oom_artifacts_equal_one_card_sweep(halved, sample):
    root = halved[0]
    for suffix in SUFFIXES:
        with open(root / "one" / f"{sample}{suffix}", "rb") as f:
            want = f.read()
        with open(root / "mesh" / f"{sample}{suffix}", "rb") as f:
            assert f.read() == want, suffix
