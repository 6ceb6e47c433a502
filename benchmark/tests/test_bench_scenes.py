"""The benchmark's seeded scene generator (``benchmark/scenes.py``) on the
CPU: the planted cell counts, the adsorption's minimum spacing, the
barcodes cycling the codebook, distinct FOVs for distinct (seed, index),
the same planes for the same ones, the same pool of geometries for every
seed, visited evenly under the frame's symmetries, and its spectra equal
to the port's synthetic FOVs'."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))

import scenes  # noqa: E402


def _load(kind, name):
    return json.loads((BENCH / kind / f"{name}.json").read_text())


def _layout(config):
    return _load("configs", config)["layout"]


@pytest.mark.parametrize("traffic,config,n", [
    ("confluent7b", "ms7b-fov2000", 3266),
    ("confluent10b", "ec10b-fov2000", 2467)])
def test_confluent_count_and_spacing(traffic, config, n):
    t = _load("traffic", traffic)
    t["pool_size"] = 1
    p = scenes.Scenes(t, _layout(config), (2000, 2000), 2**31 + 7).plan(5)
    assert len(p["codes"]) == n
    c = p["centres"]
    margin = max(t["cell_axes"]) + 12
    # a flip mirrors about the frame's middle, 1 px into the first margin
    assert c.min() >= margin - 1 and c.max() <= 2000 - margin
    d2 = ((c[:, None, :] - c[None, :, :]) ** 2).sum(-1)
    d2[np.arange(n), np.arange(n)] = np.inf
    assert np.sqrt(d2.min()) >= 0.85 * t["spacing"]
    # the frame less its margins is sqrt(1.6 n) spacings wide
    side = 2000 - 2 * margin
    assert n <= side * side / (1.6 * t["spacing"] ** 2) < n + 1


@pytest.mark.parametrize("traffic,config,stride,n_codes", [
    ("confluent7b", "ms7b-fov2000", 1, 127),
    ("sparse10b", "ec10b-fov2000", 37, 1023)])
def test_codes_cycle_the_codebook(traffic, config, stride, n_codes):
    t = _load("traffic", traffic)
    t["pool_size"] = 1
    p = scenes.Scenes(t, _layout(config), (2000, 2000), 5).plan(0)
    codes = p["codes"]
    assert codes.min() >= 1 and codes.max() <= n_codes
    assert np.all((codes[1:] - codes[:-1]) % n_codes == stride % n_codes)
    want = min(len(codes), n_codes)
    assert len(np.unique(codes)) == want


def test_sparse_grid_never_touches():
    t = _load("traffic", "sparse7b")
    t["pool_size"] = 1
    p = scenes.Scenes(t, _layout("ms7b-fov2000"), (2000, 2000), 9).plan(1)
    c = p["centres"]
    assert len(c) == 400
    d2 = ((c[:, None, :] - c[None, :, :]) ** 2).sum(-1)
    d2[np.arange(400), np.arange(400)] = np.inf
    assert np.sqrt(d2.min()) > 2 * max(t["cell_axes"])


def test_distinct_fovs_differ_and_equal_ones_are_equal():
    t = dict(_load("traffic", "confluent7b"), spacing=20, pool_size=2)
    lay = _layout("ms7b-fov2000")
    shape = (160, 160)
    seen = {}
    for seed, index in [(1, 0), (1, 1), (1, 2), (1, 3), (2, 0),
                        (2**33 + 1, 0)]:
        fovs = scenes.Scenes(t, lay, shape, seed)
        stack, truth, _ = fovs.make(index, "cpu")
        seen[seed, index] = torch.cat(stack, dim=2)
        again, _, _ = scenes.Scenes(t, lay, shape, seed).make(index, "cpu")
        assert torch.equal(torch.cat(again, dim=2), seen[seed, index])
        assert int(truth.max()) == scenes.confluent_count(shape, 20, 24)
    keys = list(seen)
    for i in range(len(keys)):
        for j in range(i + 1, len(keys)):
            assert not torch.equal(seen[keys[i]], seen[keys[j]])


def test_every_seed_visits_the_same_pool_evenly():
    t = dict(_load("traffic", "confluent7b"), spacing=20, pool_size=4)
    lay = _layout("ms7b-fov2000")

    def visits(seed):
        fovs = scenes.Scenes(t, lay, (160, 160), seed)
        return [fovs.plan(i)["geometry"] for i in range(12)]

    for seed in (3, 2**33 + 4):
        v = visits(seed)
        assert sorted(v) == sorted(list(range(4)) * 3)
    assert visits(3) != visits(2**33 + 4) or visits(5) != visits(3)
    a = scenes.Scenes(t, lay, (160, 160), 3).pool
    b = scenes.Scenes(t, lay, (160, 160), 2**33 + 4).pool
    for ga, gb in zip(a, b):
        assert np.array_equal(ga["centres"], gb["centres"])
    syms = {scenes.Scenes(t, lay, (160, 160), 3).plan(i)["symmetry"]
            for i in range(64)}
    assert syms == set(range(8))


@pytest.mark.parametrize("sym", range(8))
def test_a_symmetry_renders_the_turned_scene(sym):
    """A geometry under one of the frame's symmetries renders as the same
    symmetry of its untouched rendering."""
    t = dict(_load("traffic", "confluent7b"), spacing=20, noise=0.0,
             laser_shifts=[[0, 0]] * 4)
    lay = _layout("ms7b-fov2000")
    shape = (96, 96)
    fovs = scenes.Scenes(dict(t, pool_size=1), lay, shape, 7)
    p = fovs.plan(0)
    base = dict(p, **scenes.transform(fovs.pool[0], 0, shape))
    turned = dict(p, **scenes.transform(fovs.pool[0], sym, shape))
    _, truth0 = scenes.render(base, t, lay, shape, "cpu")
    _, truth1 = scenes.render(turned, t, lay, shape, "cpu")
    want = truth0
    if sym & 4:
        want = want.T
    if sym & 1:
        want = torch.flip(want, (0,))
    if sym & 2:
        want = torch.flip(want, (1,))
    # the same cells over the same pixels, up to one pixel at a rim
    assert (want != truth1).float().mean() < 2e-3
    assert int(truth1.max()) == int(truth0.max())


@pytest.mark.parametrize("config,layout_name", [
    ("ms7b-fov2000", "SEVEN_BIT"), ("ec10b-fov2000", "TEN_BIT")])
def test_spectra_equal_the_ports(config, layout_name):
    from hiprfish_tpu_torch import config as port_config
    from hiprfish_tpu_torch.utils import synthetic

    layout = getattr(port_config, layout_name)
    ours = scenes.barcode_spectra(_layout(config))
    for code in range(1, layout.n_barcodes + 1):
        np.testing.assert_array_equal(
            ours[code], synthetic.barcode_spectrum(layout, code))


def test_cells_render_as_ellipses_of_their_spectrum():
    t = dict(_load("traffic", "sparse7b"), n_cells=4, noise=0.0,
             laser_shifts=[[0, 0]] * 4)
    lay = _layout("ms7b-fov2000")
    stack, truth, p = scenes.Scenes(dict(t, pool_size=1), lay, (128, 128),
                                    3).make(0, "cpu")
    cube = torch.cat(stack, dim=2).numpy()
    spectra = scenes.barcode_spectra(lay)
    for i in range(4):
        px = truth.numpy() == i + 1
        area = px.sum()
        assert abs(area - np.pi * 7 * 12) < 0.15 * np.pi * 7 * 12
        rows = cube[px]
        peak = spectra[p["codes"][i]].argmax()
        np.testing.assert_allclose(rows / rows[:, peak:peak + 1],
                                   np.broadcast_to(
                                       spectra[p["codes"][i]],
                                       rows.shape), rtol=1e-5, atol=1e-6)
        # the profile falls from 1 at the centre to 0.8 at the rim
        gain = rows[:, peak] / p["gain"][i]
        assert gain.max() <= 1.0 + 1e-5 and gain.min() >= 0.8 - 1e-5
