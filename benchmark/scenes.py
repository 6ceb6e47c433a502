"""Seeded synthetic HiPR-FISH fields of view, rendered on the device.

A scene is planned on the host from ``(seed, index)``: cell centres and
orientations from a fixed pool of geometries, dealt out by the seed and
turned by one of the frame's symmetries, gains, barcodes and noise from
the seed itself (``Scenes``). Two geometries:

* ``confluent``: random sequential adsorption over the whole frame less
  its margins, no two centres nearer than 0.85 x ``spacing``, with as many
  cells n as make sqrt(1.6 n) x spacing the side of that square (the
  density of the touching microcolonies of ``make_fov``'s dense mode,
  spread over the frame);
* ``grid``: ``n_cells`` cells on a jittered square grid over the frame,
  never touching (``make_fov``'s sparse mode).

The cells are rotated ellipses whose profile falls from 1 at the centre to
0.8 at the rim; each carries the unit-peak emission spectrum of its
barcode (the sum of its fluorophores' Gaussian bumps, one per laser block
that excites it) times its gain. The cube is rendered on the device in a
few large calls: every cell's window at once, their pixels added into the
frame (no pixel lies inside more than two cells, so the sum is the same in
any order), uniform noise from a device generator, then each laser's
block rolled by its shift. The same ``(seed, index)`` gives the same
planes.

This is a frozen copy of the scene model of
``hiprfish_tpu_torch.utils.synthetic.make_fov``; it imports nothing of the
port.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

# the most tries random sequential adsorption makes per cell before the
# traffic is declared too dense for its spacing
TRIES_PER_CELL = 400


def fluorophore_spectra(layout: dict) -> np.ndarray:
    """(n_bits, C) per-fluorophore emission spectra: fluorophore k emits a
    Gaussian bump inside every laser block whose check-bit group holds k,
    peaking at a distinct channel per fluorophore; unit peak."""
    bounds = layout["block_bounds"]
    n_ch = bounds[-1]
    spectra = np.zeros((layout["n_bits"], n_ch), np.float64)
    ch = np.arange(n_ch)
    for b, group in enumerate(layout["check_bit_groups"][:len(bounds) - 1]):
        lo, hi = bounds[b], bounds[b + 1]
        width = hi - lo
        for rank, bit in enumerate(sorted(group)):
            center = lo + (rank + 1) / (len(group) + 1) * width
            spectra[bit] += np.exp(-((ch - center) ** 2)
                                   / (2 * (width / 6.0) ** 2))
    return spectra / np.maximum(spectra.max(axis=1, keepdims=True), 1e-12)


def barcode_spectra(layout: dict) -> np.ndarray:
    """(2^n_bits, C) unit-peak spectrum of every barcode (row 0 unused):
    the sum of its fluorophores' spectra, bit 0 the code string's first."""
    spectra = fluorophore_spectra(layout)
    n_bits = layout["n_bits"]
    codes = np.arange(2 ** n_bits)
    bits = (codes[:, None] >> (n_bits - 1 - np.arange(n_bits))[None]) & 1
    out = bits.astype(np.float64) @ spectra
    out[0] = 0.0
    return out / np.maximum(out.max(axis=1, keepdims=True), 1e-12)


def confluent_count(shape, spacing: float, margin: float) -> int:
    """The n whose square of side sqrt(1.6 n) x spacing fills the frame
    less its margins."""
    side = min(shape) - 2 * margin
    return int(side * side / (1.6 * spacing * spacing))


def _adsorb(rng: np.random.Generator, n: int, spacing: float, box):
    """(n, 2) centres placed by random sequential adsorption in box (y0,
    y1, x0, x1): each try is kept unless it lies nearer than 0.85 x
    spacing to a kept centre. Tries are drawn in bulk; each is tested
    against the kept centres of its 3 x 3 neighbourhood of a grid whose
    cells are one minimum distance wide. Raises if n centres do not fit
    in TRIES_PER_CELL x n tries."""
    y0, y1, x0, x1 = box
    dmin = 0.85 * spacing
    d2min = dmin * dmin
    gy = int(math.ceil((y1 - y0) / dmin)) + 1
    gx = int(math.ceil((x1 - x0) / dmin)) + 1
    grid = [[] for _ in range(gy * gx)]
    pts = []
    tries = 0
    while len(pts) < n:
        if tries >= TRIES_PER_CELL * n:
            raise ValueError(f"adsorption jammed: {len(pts)} of {n} cells "
                             f"at spacing {spacing}")
        batch = 4 * (n - len(pts)) + 256
        tries += batch
        cy = rng.uniform(y0, y1, batch).tolist()
        cx = rng.uniform(x0, x1, batch).tolist()
        for y, x in zip(cy, cx):
            iy, ix = int((y - y0) / dmin), int((x - x0) / dmin)
            ok = True
            for jy in range(max(iy - 1, 0), min(iy + 2, gy)):
                for jx in range(max(ix - 1, 0), min(ix + 2, gx)):
                    for py, px in grid[jy * gx + jx]:
                        if (py - y) ** 2 + (px - x) ** 2 < d2min:
                            ok = False
                            break
                    if not ok:
                        break
                if not ok:
                    break
            if ok:
                grid[iy * gx + ix].append((y, x))
                pts.append((y, x))
                if len(pts) == n:
                    break
    return np.asarray(pts, np.float64)


def plan_geometry(traffic: dict, shape, rng: np.random.Generator) -> dict:
    """Cell centres and angles of one geometry of the traffic."""
    h, w = shape
    axes = traffic["cell_axes"]
    margin = max(axes) + 12
    if traffic["geometry"] == "confluent":
        n = confluent_count(shape, traffic["spacing"], margin)
        centres = _adsorb(rng, n, traffic["spacing"],
                          (margin, h - margin, margin, w - margin))
    elif traffic["geometry"] == "grid":
        n = traffic["n_cells"]
        g = int(math.ceil(math.sqrt(n)))
        ys = np.linspace(margin, h - margin, g)
        xs = np.linspace(margin, w - margin, g)
        i = np.arange(n)
        jit = rng.uniform(-1.0, 1.0, (n, 2)) * traffic["jitter_px"]
        centres = np.stack([ys[i // g], xs[i % g]], axis=1) + jit
    else:
        raise ValueError(f"unknown geometry {traffic['geometry']!r}")
    return {"centres": centres, "theta": rng.uniform(0.0, np.pi, n)}


def transform(geo: dict, t: int, shape) -> dict:
    """One of the square frame's eight symmetries applied to a geometry:
    bit 2 transposes, bit 0 flips the rows, bit 1 the columns. A cell's
    axis at angle theta (its direction (cos, sin) in (y, x)) turns with
    it."""
    h, w = shape
    y, x = geo["centres"][:, 0], geo["centres"][:, 1]
    th = geo["theta"]
    if t & 4:
        y, x, th = x, y, np.pi / 2 - th
    if t & 1:
        y, th = (h - 1) - y, np.pi - th
    if t & 2:
        x, th = (w - 1) - x, np.pi - th
    return {"centres": np.stack([y, x], axis=1), "theta": np.mod(th, np.pi)}


class Scenes:
    """The FOVs of one run: FOV ``index`` of seed ``seed``.

    The traffic's ``pool_size`` geometries are planned once from its
    ``pool_seed``, the same for every seed, so that every run does the
    same work (the fixpoint floods' rounds follow the geometry). FOV
    ``index`` takes geometry ``deal[index % pool_size]`` of a permutation
    that the seed draws, so a window visits the pool evenly, under one of
    the frame's eight symmetries, and its own gains, barcode offset and
    noise, all drawn from (seed, index): no two FOVs of a run are the
    same planes."""

    def __init__(self, traffic: dict, layout: dict, shape, seed: int):
        if shape[0] != shape[1]:
            raise ValueError(f"the FOV must be square, not {shape}")
        self.traffic, self.layout, self.shape = traffic, layout, tuple(shape)
        self.seed = int(seed)
        n_pool = int(traffic["pool_size"])
        self.pool = [plan_geometry(traffic, self.shape, np.random.default_rng(
            np.random.SeedSequence([int(traffic["pool_seed"]), g])))
            for g in range(n_pool)]
        self.deal = np.random.default_rng(np.random.SeedSequence(
            [self.seed, n_pool, 0xDEA1])).permutation(n_pool)

    def plan(self, index: int) -> dict:
        """The host half of FOV ``index``: centres, angles, gains,
        barcodes and the noise's seed."""
        rng = np.random.default_rng(np.random.SeedSequence(
            [self.seed, int(index), 0xF0F]))
        g = int(self.deal[index % len(self.pool)])
        t = int(rng.integers(8))
        geo = transform(self.pool[g], t, self.shape)
        n = len(geo["theta"])
        n_codes = 2 ** self.layout["n_bits"] - 1
        offset = int(rng.integers(n_codes))
        codes = (np.arange(n) * self.traffic["code_stride"] + offset) \
            % n_codes + 1
        return dict(geo, geometry=g, symmetry=t,
                    gain=self.traffic["brightness"] * rng.uniform(0.8, 1.2, n),
                    codes=codes.astype(np.int64),
                    noise_seed=int(rng.integers(2 ** 62)))

    def make(self, index: int, device, timings: dict | None = None):
        """(per-laser planes, truth labels, plan) of FOV ``index`` on
        ``device``; adds the host and device seconds to ``timings``
        ('plan_s', 'render_s')."""
        t0 = time.perf_counter()
        p = self.plan(index)
        t1 = time.perf_counter()
        stack, truth = render(p, self.traffic, self.layout, self.shape,
                              device)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        t2 = time.perf_counter()
        if timings is not None:
            timings["plan_s"] = timings.get("plan_s", 0.0) + t1 - t0
            timings["render_s"] = timings.get("render_s", 0.0) + t2 - t1
        return stack, truth, p


def render(p: dict, traffic: dict, layout: dict, shape, device):
    """(tuple of per-laser (H, W, C_l) float32 planes, (H, W) int32 truth
    labels, cell i + 1 for the i-th planned cell) on ``device``."""
    h, w = shape
    f32 = dict(dtype=torch.float32, device=device)
    a, b = traffic["cell_axes"]            # semi-minor, semi-major
    win = int(math.ceil(max(a, b))) + 2
    off = torch.arange(-win, win + 1, device=device)
    centres = torch.as_tensor(p["centres"], **f32)
    n = centres.shape[0]
    base = torch.floor(centres).to(torch.int64)
    rows = base[:, 0, None, None] + off[None, :, None]        # (n, W, 1)
    cols = base[:, 1, None, None] + off[None, None, :]        # (n, 1, W)
    dy = rows.to(torch.float32) - centres[:, 0, None, None]
    dx = cols.to(torch.float32) - centres[:, 1, None, None]
    th = torch.as_tensor(p["theta"], **f32)[:, None, None]
    u = dy * torch.cos(th) + dx * torch.sin(th)
    v = -dy * torch.sin(th) + dx * torch.cos(th)
    r2 = (u / b) ** 2 + (v / a) ** 2
    inside = (r2 <= 1.0) & (rows >= 0) & (rows < h) & (cols >= 0) \
        & (cols < w)
    cell = torch.arange(n, device=device)[:, None, None].expand_as(inside)
    pix = (rows * w + cols).expand_as(inside)[inside]
    cell = cell[inside]
    weight = (1.0 - 0.2 * torch.sqrt(r2[inside])) \
        * torch.as_tensor(p["gain"], **f32)[cell]
    spectra = torch.as_tensor(barcode_spectra(layout), **f32)
    codes = torch.as_tensor(p["codes"], device=device)
    n_ch = spectra.shape[1]
    image = torch.zeros((h * w, n_ch), **f32)
    image.index_add_(0, pix, weight[:, None] * spectra[codes[cell]])
    truth = torch.full((h * w,), n + 1, dtype=torch.int32, device=device)
    truth.scatter_reduce_(0, pix, (cell + 1).to(torch.int32), "amin")
    truth = torch.where(truth > n, torch.zeros_like(truth), truth)
    gen = torch.Generator(device=device)
    gen.manual_seed(p["noise_seed"])
    image = image.reshape(h, w, n_ch)
    image += torch.rand((h, w, n_ch), generator=gen, **f32) \
        * traffic["noise"]
    bounds = layout["block_bounds"]
    stack = tuple(
        torch.roll(image[:, :, bounds[i]:bounds[i + 1]], tuple(s),
                   dims=(0, 1)).contiguous()
        for i, s in enumerate(traffic["laser_shifts"]))
    return stack, truth.reshape(h, w)
