"""Port parity for the scale-out (hiprfish_tpu_torch/parallel/ and the
mesh paths of pipeline/segment3d.py) in gloo worlds on the CPU, against
the JAX package on the conftest's virtual 8-device mesh.

Each world, (fov, tile) = (2, 1) on two processes and (2, 2) on four, is
started once (tests/torch_world.py); every rank runs every check and
writes its results, and each case below holds every rank's copy:
- lp_cv_enhance_2d_sharded over each dim of two ranks: bitwise the port's
  unsharded B2 plain version, and within 1e-6 of the JAX function on its
  'tile' axis (tests/test_parallel.py's tolerance against the unsharded
  XLA program);
- batched_fov_step on four distinct 64^2 FOVs and batched_fov_step_ecoli
  on two distinct 192^2 10-bit FOVs duplicated to four: n_cells, labels
  and calls equal to the JAX fov_step / fov_step_ecoli per FOV; a batch
  that does not divide by 'fov' raises before any collective;
- train_check_heads_dp: within 1e-5 of the one-process trainer on the
  same rows after 20 steps (only the gradient's summation order differs),
  within ROADMAP §C's 2e-4 of the JAX function after 20 on a mesh of as
  many 'fov' shards (the JAX function itself moves by 2.2e-4 after one
  step, 1.2e-3 after 20, between 4 shards and 2: Adam's first steps take
  the sign of gradients near zero, whose rounding follows the shards),
  and the JAX test's accuracy > 0.9 after 200;
- segment_3d_tiled(mesh=) on tests/test_parallel.py's 128 x 48 x 24
  volume: the labels of the port's host sweep and of the JAX host sweep;
  with global_seeds=False (each tile seeds its own slab, the replayed
  last slab too), the labels of the port's one-process in-tile sweep;
- measure_volume_zsharded: within 2e-6 of the JAX function on every
  label (row 0 is zero in the port, which leaves the background out, as
  its measure_volume_streamed does), and the ragged-Z ValueError.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
import torch_world
from hiprfish_tpu.config import SEVEN_BIT as JSEVEN_BIT
from hiprfish_tpu.config import TEN_BIT as JTEN_BIT
from hiprfish_tpu.config import SegmentationConfig as JSegmentationConfig
from hiprfish_tpu.models import artifacts as jartifacts
from hiprfish_tpu.models.classifier import _init_mlp, _mlp_logit
from hiprfish_tpu.parallel import fov_batch as jfov_batch
from hiprfish_tpu.parallel import mesh as jmeshlib
from hiprfish_tpu.parallel import spatial as jspatial
from hiprfish_tpu.pipeline import fused as jfused
from hiprfish_tpu.pipeline import fused_ecoli as jfused_ecoli
from hiprfish_tpu.pipeline import segment3d as jsegment3d
from hiprfish_tpu.utils import synthetic as jsynthetic
from hiprfish_tpu_torch.config import SegmentationConfig
from hiprfish_tpu_torch.ops import line_profile
from hiprfish_tpu_torch.pipeline import segment3d

torch.set_num_threads(1)

FIXTURE_10B = os.path.join(os.path.dirname(__file__), "fixtures",
                           "torch_port_clf_10b_1023x200.npz")
CFG7 = dict(watershed_max_iters=64, ccl_max_iters=64, kmeans_iters=10)
CFG10 = dict(watershed_max_iters=64, ccl_max_iters=128, kmeans_iters=10)
CODES10 = [5, 37, 515, 1023, 96, 640, 17, 260, 770]
TILED = dict(max_cells=256, tile_x=16, margin=8, tile_cap=64, chunk_xy=32)
WORLDS = [(2, 1), (2, 2)]
CHECKS = ("lpcv", "fov_step", "ecoli", "train", "seg3d", "zsharded")


def _volume():
    """tests/test_parallel.py's 128 x 48 x 24 volume: 8 tiles of 16
    voxels with 8-voxel margins, one cell on a boundary."""
    rng = np.random.RandomState(7)
    x, y, z = 128, 48, 24
    vol = rng.rand(x, y, z).astype(np.float32) * 0.05
    xx, yy, zz = np.mgrid[:x, :y, :z]
    for cx, cy, cz in [(20, 24, 12), (40, 12, 8), (70, 30, 16),
                       (100, 20, 10), (63, 36, 12)]:
        r2 = ((xx - cx) / 6.0) ** 2 + ((yy - cy) / 5.0) ** 2 \
            + ((zz - cz) / 4.0) ** 2
        vol += np.where(r2 <= 1.0, 1.0 - 0.3 * r2, 0.0)
    return vol.astype(np.float32)


@pytest.fixture(scope="module")
def mesh8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    return jmeshlib.make_mesh(8, fov=4, tile=2)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The worlds' inputs, written once, and the references that need no
    mesh."""
    d = tmp_path_factory.mktemp("inputs")
    rng = np.random.RandomState(0)
    ref = {}
    # 2D LP-CV
    img = rng.rand(128, 96).astype(np.float32)
    np.save(d / "img.npy", img)
    ref["img"] = img
    # 7-bit: the JAX test's tiny classifier, four distinct 64^2 FOVs
    _, _, _, clf = graft._tiny_classifier_and_fov(shape=(64, 64),
                                                  with_clf=True)
    jartifacts.save_classifier(str(d / "clf7.npz"), clf)
    fovs = [jsynthetic.make_fov(JSEVEN_BIT, [1, 9, 65, 127], shape=(64, 64),
                                seed=s, cell_axes=(7.0, 12.0))
            for s in range(4)]
    stack7 = [np.stack([np.asarray(f["stack"][li], np.float32)
                        for f in fovs]) for li in range(4)]
    np.savez(d / "stack7.npz", **{f"laser{i}": a
                                  for i, a in enumerate(stack7)})
    ja, js = jfused.classifier_to_device_args(clf)
    ref["fov_step"] = [jfused.fov_step(
        tuple(jnp.asarray(a[i]) for a in stack7), ja,
        JSegmentationConfig(**CFG7), 32, js, False) for i in range(4)]
    # 10-bit: two distinct 192^2 FOVs, duplicated to four
    stacks = []
    for i in range(2):
        f = jsynthetic.make_fov(JTEN_BIT, CODES10[:6 + 3 * i],
                                shape=(192, 192), seed=20 + i,
                                cell_axes=(9.0, 14.0))
        stacks.append([np.asarray(a, np.float32) for a in f["stack"]])
    stack10 = [np.stack([s[li] for s in stacks + stacks])
               for li in range(len(stacks[0]))]
    np.savez(d / "stack10.npz", **{f"laser{i}": a
                                   for i, a in enumerate(stack10)})
    ja10, js10 = jfused.classifier_to_device_args(
        jartifacts.load_classifier(FIXTURE_10B))
    ref["ecoli"] = [jfused_ecoli.fov_step_ecoli(
        tuple(jnp.asarray(a) for a in stacks[i]), ja10,
        JSegmentationConfig(**CFG10), 64, js10, 64) for i in range(2)]
    # check-head training: the JAX test's rows and initial parameters
    x = rng.rand(512, 23).astype(np.float32)
    y = (x.mean(1) > 0.5).astype(np.float32)
    init = {k: np.asarray(v) for k, v in
            _init_mlp(jax.random.PRNGKey(0), 23, 32).items()}
    np.savez(d / "train.npz", x=x, y=y, **init)
    ref["train"] = (x, y, init)
    # the 3D tiled sweep
    vol = _volume()
    np.save(d / "vol3d.npy", vol)
    seg_j, n_j, _ = jsegment3d.segment_3d_tiled(
        jnp.asarray(vol), JSegmentationConfig(), **TILED)
    seg_t, n_t, _ = segment3d.segment_3d_tiled(
        torch.from_numpy(vol), SegmentationConfig(), **TILED)
    ref["seg3d"] = (np.asarray(seg_j), int(n_j), seg_t.numpy(), int(n_t))
    seg_in, n_in, _ = segment3d.segment_3d_tiled(
        torch.from_numpy(vol), SegmentationConfig(), global_seeds=False,
        **TILED)
    ref["seg3d_in_tile"] = (seg_in.numpy(), int(n_in))
    # the z-sharded measurement (tests/test_parallel.py's volume)
    zr = np.random.RandomState(11)
    seg = np.zeros((40, 32, 16), np.int32)
    seg[4:12, 6:14, 2:9] = 1
    seg[20:30, 10:20, 5:13] = 2
    seg[32:39, 2:10, 8:15] = 3
    vol_cm = zr.rand(5, 16, 40, 32).astype(np.float32)
    np.savez(d / "zsharded.npz", seg=seg, vol_cm=vol_cm)
    ref["zsharded"] = (seg, vol_cm)
    return d, ref


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"fov{w[0]}"
                f"_tile{w[1]}")
def world(request, inputs, tmp_path_factory):
    fov, tile = request.param
    out = torch_world.run_world(
        tmp_path_factory.mktemp(f"world_{fov}x{tile}"), fov * tile, CHECKS,
        timeout=400, fov=fov, tile=tile, inputs=str(inputs[0]), cfg7=CFG7,
        max_cells7=32, clf10=FIXTURE_10B, cfg10=CFG10, max_cells10=64,
        tiled=TILED)
    return out, fov * tile


def test_lp_cv_sharded_bitwise_unsharded_b2(world, inputs):
    out, n = world
    want = line_profile.lp_cv_enhance_2d_plain(
        torch.from_numpy(inputs[1]["img"])).numpy()
    for res in torch_world.load(out, "lpcv", n):
        assert set(res) >= {"fov"}
        for got in res.values():
            np.testing.assert_array_equal(got, want)


def test_lp_cv_sharded_matches_jax(world, inputs, mesh8):
    out, n = world
    want = np.asarray(jspatial.lp_cv_enhance_2d_sharded(
        jnp.asarray(inputs[1]["img"]), mesh8, "tile"))
    for res in torch_world.load(out, "lpcv", n):
        for got in res.values():
            np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_batched_fov_step_matches_jax_per_fov(world, inputs):
    out, n = world
    refs = inputs[1]["fov_step"]
    for res in torch_world.load(out, "fov_step", n):
        assert res["seg"].shape == (4, 64, 64)
        for i, jr in enumerate(refs):
            assert int(res["n_cells"][i]) == int(jr.n_cells)
            np.testing.assert_array_equal(res["seg"][i],
                                          np.asarray(jr.segmentation))
            v = np.asarray(jr.valid)
            np.testing.assert_array_equal(res["valid"][i], v)
            np.testing.assert_array_equal(res["code_idx"][i][v],
                                          np.asarray(jr.code_idx)[v])
        assert sum(int(jr.n_cells) for jr in refs) >= 8


def test_batched_fov_step_rejects_ragged_batch(world):
    out, n = world
    for res in torch_world.load(out, "fov_step", n):
        assert "must divide by mesh['fov']=2" in str(res["ragged"])


def test_batched_fov_step_ecoli_matches_jax_per_fov(world, inputs):
    out, n = world
    refs = inputs[1]["ecoli"]
    assert int(refs[0][1]) != int(refs[1][1])
    for res in torch_world.load(out, "ecoli", n):
        for i in range(4):
            jr = refs[i % 2]
            n_i = int(res["n_cells"][i])
            assert n_i == int(jr[1]) > 0
            np.testing.assert_array_equal(res["seg"][i], np.asarray(jr[0]))
            np.testing.assert_array_equal(res["code_idx"][i][1:n_i + 1],
                                          np.asarray(jr[3])[1:n_i + 1])


def _params(res, tag):
    return {k: res[f"{tag}_{k}"] for k in ("w1", "b1", "w2", "b2")}


def test_train_dp_matches_one_process_trainer(world):
    out, n = world
    for res in torch_world.load(out, "train", n):
        dp, one = _params(res, "dp20"), _params(res, "one20")
        for k in dp:
            np.testing.assert_allclose(dp[k], one[k].reshape(dp[k].shape),
                                       atol=1e-5, rtol=0)


def test_train_dp_matches_jax(world, inputs):
    out, n = world
    x, y, init = inputs[1]["train"]
    # the JAX function over as many 'fov' shards as the world has
    want = jfov_batch.train_check_heads_dp(
        jmeshlib.make_mesh(2, fov=2, tile=1), x, y,
        {k: jnp.asarray(v) for k, v in init.items()}, steps=20, lr=3e-3)
    results = torch_world.load(out, "train", n)
    for res in results:
        got = _params(res, "dp20")
        for k in got:
            np.testing.assert_allclose(got[k], np.asarray(want[k]),
                                       atol=2e-4, rtol=0)
        # every rank holds the same parameters
        for k in got:
            np.testing.assert_array_equal(got[k], _params(results[0],
                                                          "dp20")[k])


def test_train_dp_accuracy(world, inputs):
    out, n = world
    x, y, _ = inputs[1]["train"]
    for res in torch_world.load(out, "train", n):
        p = {k: jnp.asarray(v) for k, v in _params(res, "dp200").items()}
        acc = np.mean((np.asarray(_mlp_logit(p, jnp.asarray(x))) > 0)
                      == (y > 0.5))
        assert acc > 0.9


def test_segment_3d_tiled_mesh_matches_host_sweeps(world, inputs):
    out, n = world
    seg_j, n_j, seg_t, n_t = inputs[1]["seg3d"]
    assert n_t == n_j > 0
    np.testing.assert_array_equal(seg_t, seg_j)
    for res in torch_world.load(out, "seg3d", n):
        assert int(res["n_cells"]) == n_t
        np.testing.assert_array_equal(res["seg"], seg_t)


def test_segment_3d_tiled_mesh_in_tile_seeds_matches_host_sweep(world,
                                                               inputs):
    out, n = world
    seg_in, n_in = inputs[1]["seg3d_in_tile"]
    assert n_in > 0
    for res in torch_world.load(out, "seg3d", n):
        assert int(res["n_in_tile"]) == n_in
        np.testing.assert_array_equal(res["seg_in_tile"], seg_in)


def test_measure_zsharded_matches_jax(world, inputs, mesh8):
    out, n = world
    seg, vol_cm = inputs[1]["zsharded"]
    want = np.asarray(jsegment3d.measure_volume_zsharded(
        jnp.asarray(seg), jnp.asarray(vol_cm),
        jmeshlib.make_mesh(8, fov=8, tile=1), axis="fov", max_cells=16))
    for res in torch_world.load(out, "zsharded", n):
        got = res["spectra"]
        assert got.shape == want.shape == (16, 5)
        np.testing.assert_allclose(got[1:], want[1:], rtol=2e-6, atol=2e-6)
        assert (got[0] == 0).all() and (got[4:] == 0).all()


def test_measure_zsharded_rejects_ragged_z(world):
    out, n = world
    for res in torch_world.load(out, "zsharded", n):
        assert "must divide by mesh['fov']=2" in str(res["ragged"])
