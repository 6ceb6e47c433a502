"""Port parity: CCL, ranking and binary morphology vs the JAX package on
the CPU (label images and masks must be equal)."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hiprfish_tpu.ops import labeling as jlab
from hiprfish_tpu.ops import morphology as jmorph
from hiprfish_tpu.ops import segstats as jseg
from hiprfish_tpu_torch import kernels
from hiprfish_tpu_torch.ops import labeling as tlab
from hiprfish_tpu_torch.ops import morphology as tmorph
from hiprfish_tpu_torch.ops import segstats as tseg

torch.set_num_threads(1)


def _blobs(shape, seed, n=25, holes=True):
    """Random ellipses (some with holes) — snake-shaped and nested
    components exercise the scans' run caps and the fixpoint loop."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:shape[0], :shape[1]]
    m = np.zeros(shape, bool)
    for _ in range(n):
        cy, cx = rng.uniform(0, shape[0]), rng.uniform(0, shape[1])
        a, b = rng.uniform(2, 9), rng.uniform(2, 20)
        th = rng.uniform(0, np.pi)
        u = (yy - cy) * np.cos(th) + (xx - cx) * np.sin(th)
        v = -(yy - cy) * np.sin(th) + (xx - cx) * np.cos(th)
        r2 = (u / b) ** 2 + (v / a) ** 2
        m |= r2 <= 1.0
        if holes and a > 5:
            m &= ~(r2 <= 0.15)
    # a serpentine component longer than any scan cap
    m[5, 3:90] = True
    m[5:40, 89] = True
    m[39, 10:90] = True
    return m


@pytest.mark.parametrize("connectivity,max_run", [(1, None), (2, None),
                                                  (2, 16), (1, 8)])
def test_label_equal(connectivity, max_run):
    m = _blobs((96, 128), 0)
    ref = np.asarray(jlab.label(jnp.asarray(m), connectivity, 512, max_run))
    out = tlab.label(torch.from_numpy(m), connectivity, 512, max_run)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("max_run", [None, 16])
def test_rank_labels_equal(max_run):
    m = _blobs((80, 112), 1)
    lbl = jlab.label(jnp.asarray(m), 2, 512, max_run)
    ref, n_ref = jseg.rank_labels(lbl, 2, 512, max_run)
    out, n = tseg.rank_labels(torch.from_numpy(np.array(lbl)), 2, 512,
                              max_run)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert int(n) == int(n_ref) > 5


def test_label_fixpoint_cap_matches_reference():
    # a cap of 1 iteration stops both before convergence, identically
    m = _blobs((64, 96), 2)
    ref = np.asarray(jlab.label(jnp.asarray(m), 2, 1, 4))
    out = tlab.label(torch.from_numpy(m), 2, 1, 4).numpy()
    np.testing.assert_array_equal(out, ref)
    full = tlab.label(torch.from_numpy(m), 2, 512, 4).numpy()
    assert (out != full).any()


@pytest.mark.parametrize("seed", [3, 4])
def test_binary_opening_equal(seed):
    m = _blobs((72, 90), seed)
    np.testing.assert_array_equal(
        tmorph.binary_opening(torch.from_numpy(m)).numpy(),
        np.asarray(jmorph.binary_opening(jnp.asarray(m))))


@pytest.mark.parametrize("connectivity,max_run", [(1, 64), (1, None),
                                                  (2, 8)])
def test_binary_fill_holes_equal(connectivity, max_run):
    m = _blobs((90, 120), 5)
    ref = np.asarray(jmorph.binary_fill_holes(jnp.asarray(m), connectivity,
                                              max_run))
    out = tmorph.binary_fill_holes(torch.from_numpy(m), connectivity,
                                   max_run).numpy()
    assert (ref & ~m).any()          # some hole was filled
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("op", ["all", "any"])
def test_block_pool_equal(op):
    m = _blobs((45, 98), 6)
    np.testing.assert_array_equal(
        tlab._block_pool(torch.from_numpy(m), 4, op).numpy(),
        np.asarray(jlab._block_pool(jnp.asarray(m), 4, op)))


@pytest.mark.parametrize("off,fill", [((1, 0), 0), ((-2, 3), 7),
                                      ((0, -1), -1), ((200, 0), 5)])
def test_shifted_equal(off, fill):
    a = np.arange(48 * 40, dtype=np.int32).reshape(48, 40)
    np.testing.assert_array_equal(
        tlab.shifted(torch.from_numpy(a), off, fill).numpy(),
        np.asarray(jlab.shifted(jnp.asarray(a), off, fill)))


def test_border_mask_equal():
    np.testing.assert_array_equal(tlab.border_mask((5, 7)).numpy(),
                                  np.asarray(jlab.border_mask((5, 7))))


# -- one flood round in closed form ------------------------------------------
# What csrc/flood.cu computes, and the plan of its passes
# (kernels.flood_plan), held against the plain round bodies.

def _offsets_np(ndim, lo, hi):
    return [o for o in itertools.product((-1, 0, 1), repeat=ndim)
            if lo <= sum(map(abs, o)) <= hi]


def _neighbor_np(cur, mask, offsets, op, ident):
    """The neighbour pass: op of cur over the offsets (ident outside the
    array, read whatever the mask) and the voxel, ident off the mask."""
    pad = np.pad(cur, 1, constant_values=ident)
    acc = cur.copy()
    for off in offsets:
        acc = op(acc, pad[tuple(slice(1 + o, 1 + o + s)
                                for o, s in zip(off, cur.shape))])
    return np.where(mask, acc, ident)


def _runs_np(v, mask, axis, radius, op):
    """Each mask voxel takes op over the voxels within ``radius`` of it
    along ``axis`` inside its unbroken mask run; others keep theirs."""
    v = np.moveaxis(v, axis, -1)
    m = np.moveaxis(mask, axis, -1)
    out = v.copy()
    n = v.shape[-1]
    for idx in np.ndindex(v.shape[:-1]):
        line, ml, j = v[idx], m[idx], 0
        while j < n:
            if not ml[j]:
                j += 1
                continue
            s = j
            while j < n and ml[j]:
                j += 1
            for p in range(s, j):
                out[idx + (p,)] = op.reduce(line[max(s, p - radius):
                                                 min(j, p + radius + 1)])
    return np.moveaxis(out, -1, axis)


def _round_np(cur, mask, connectivity, max_run, kind):
    """The round's closed form over the tensor's own axes."""
    nd = cur.ndim
    op, ident = (np.minimum, tlab._INF) if kind == "min" \
        else (np.logical_or, False)
    full = kind == "min" and connectivity == nd
    v = _neighbor_np(cur, mask, _offsets_np(nd, 1, nd) if full
                     else _offsets_np(nd, 2, connectivity), op, ident)
    for ax in range(nd):
        v = _runs_np(v, mask, ax, kernels.run_window(cur.shape[ax], max_run),
                     op)
    return v


def _plan_np(cur, mask, connectivity, max_run, kind):
    """The passes of kernels.flood_plan over the (n0, n1, n2) view."""
    op, ident = (np.minimum, tlab._INF) if kind == "min" \
        else (np.logical_or, False)
    shape3 = (1,) * (3 - cur.ndim) + cur.shape
    v, m = cur.reshape(shape3), mask.reshape(shape3)
    full = kind == "min" and connectivity == cur.ndim
    for step in kernels.flood_plan(cur.shape, connectivity, max_run, full,
                                   cur.dtype.itemsize):
        if step[0] == "neighbor":
            _, side, mid = step
            offs = [o for o in _offsets_np(3, 1, 3)
                    if (o[0] != 0 and side >> (abs(o[1]) + abs(o[2])) & 1)
                    or (o[0] == 0 and mid >> (abs(o[1]) + abs(o[2])) & 1)]
            v = _neighbor_np(v, m, offs, op, ident)
        else:
            _, axis, radius, fold = step
            v = _runs_np(np.where(m, v, ident) if fold else v, m, axis,
                         radius, op)
    return v.reshape(cur.shape)


ROUND_SHAPES = {1: (301,), 2: (23, 141), 3: (5, 7, 133)}


@pytest.mark.parametrize("kind", ["min", "reach"])
@pytest.mark.parametrize("max_run", [None, 1, 2, 5, 16, 32, 128])
@pytest.mark.parametrize("ndim,connectivity", [(1, 1), (2, 1), (2, 2),
                                               (3, 1), (3, 2), (3, 3)])
def test_round_closed_form(ndim, connectivity, max_run, kind):
    """One round of _min_round / _reach_round on the CPU (the plain body)
    is the closed form, and so are the passes of kernels.flood_plan:
    random masks and states of odd sizes, the min state with values off
    the mask (round 1 of rank reads them), runs longer than every cap."""
    rng = np.random.default_rng(100 * ndim + 10 * connectivity
                                + (max_run or 0))
    shape = ROUND_SHAPES[ndim]
    mask = rng.random(shape) < rng.choice([0.55, 0.8, 0.95])
    if kind == "min":
        cur = rng.integers(1, 5000, shape).astype(np.int32)
        cur[rng.random(shape) < 0.2] = tlab._INF
        (got,) = tlab._min_round(ndim, connectivity, max_run)(
            (torch.from_numpy(cur),),
            (torch.from_numpy(mask),
             torch.full(shape, tlab._INF, dtype=torch.int32)))
    else:
        cur = rng.random(shape) < 0.05
        (got,) = tlab._reach_round(ndim, connectivity, max_run)(
            (torch.from_numpy(cur),), (torch.from_numpy(mask),))
    want = _round_np(cur, mask, connectivity, max_run, kind)
    assert (cur != want).any()
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        _plan_np(cur, mask, connectivity, max_run, kind), want)
