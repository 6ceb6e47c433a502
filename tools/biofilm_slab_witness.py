"""How fragile the biofilm engine's labels are on chip_smoke.py's 192^2 slab
FOV, and whether phase 15a's bar there tells a harmless change of the last
bits from a wrong kernel.

    python tools/biofilm_slab_witness.py [--device cpu]

It runs segment2d.segment_lpcv(..., "biofilm") at bkg_min_size=200,
epithelial_disk_radius=6 on the seed-5 FOV with chip_smoke's two slabs,
once as it is and then with one change each:

  * ``noise s``: uniform noise of +-2e-6 (generator seed s) added to the
    denoised image, the size of the card's and the CPU's disagreement on
    it;
  * ``B1 h 0.021``: NL-means at h 0.021 instead of 0.02 (a wrong B1);
  * ``B2 phi 8``: LP-CV over 8 orientations instead of 9 (a wrong B2);
  * ``no adjacency flood``: the segmentation in place of the adjacency
    labels (a flood that does nothing).

For each it prints n_cells, the epithelial pixels, the share of pixels
whose labels equal the first run's, and chip_smoke's paired agreement on
the pixels more than SLAB_MARGIN px from the slabs, which 15a holds at
>= 0.999. Then the largest change the wrong B1 and B2 make to their own
outputs on the slab FOV's inputs, which 15a's replay of the stages holds
within chip_smoke.TOL. Runs on the CPU by default; imports neither jax
nor the JAX package.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import (BIOFILM_CODES_192, SLAB_MARGIN,  # noqa: E402
                        SLABS_192, TOL, _matched_agreement, _plant_slabs,
                        _slab_region)
from hiprfish_tpu_torch.config import (SEVEN_BIT,  # noqa: E402
                                       SegmentationConfig)
from hiprfish_tpu_torch.ops import denoise, line_profile  # noqa: E402
from hiprfish_tpu_torch.pipeline import segment2d  # noqa: E402
from hiprfish_tpu_torch.utils import synthetic  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    plain = synthetic.make_fov(SEVEN_BIT, list(BIOFILM_CODES_192),
                               shape=(192, 192), seed=5,
                               cell_axes=(7.0, 12.0))["stack"]
    stack = tuple(torch.from_numpy(a).to(dev)
                  for a in _plant_slabs(plain, *SLABS_192))
    cfg = SegmentationConfig(bkg_min_size=200, epithelial_disk_radius=6)
    away = _slab_region((192, 192), *SLABS_192, SLAB_MARGIN)

    def run(c=cfg):
        r = segment2d.segment_lpcv(stack, None, c, 128, "biofilm")
        return {"n_cells": int(r.n_cells), "fov_sum": r.fov_sum,
                "segmentation": r.segmentation.cpu().numpy(),
                "adjacency": r.adjacency.cpu().numpy(),
                "epithelial": r.epithelial.cpu().numpy()}

    base = run()
    nlm = segment2d.dn.denoise_nl_means_auto
    runs = {}
    for seed in (1, 2, 3):
        gen = torch.Generator(device=dev).manual_seed(seed)

        def noisy(*a, **kw):
            d = nlm(*a, **kw)
            return d + (torch.rand(d.shape, generator=gen, device=dev)
                        - 0.5) * 4e-6

        segment2d.dn.denoise_nl_means_auto = noisy
        try:
            runs[f"noise {seed}"] = run()
        finally:
            segment2d.dn.denoise_nl_means_auto = nlm
    runs["B1 h 0.021"] = run(dataclasses.replace(cfg, nlm_h=0.021))
    runs["B2 phi 8"] = run(dataclasses.replace(cfg, phi_range=8))
    runs["no adjacency flood"] = dict(base, adjacency=base["segmentation"])

    print(f"base: n_cells {base['n_cells']}, epithelial px "
          f"{int(base['epithelial'].sum())}; paired agreement on the "
          f"{int(away.sum())} px more than {SLAB_MARGIN} px from the slabs")
    for name, r in runs.items():
        equal = {k: float((r[k] == base[k]).mean())
                 for k in ("segmentation", "adjacency", "epithelial")}
        paired = {k: _matched_agreement(base[k], r[k], away)
                  for k in ("segmentation", "adjacency")}
        print(f"{name}: n_cells {r['n_cells']}, epithelial px "
              f"{int(r['epithelial'].sum())}, equal "
              + ", ".join(f"{k} {v:.4f}" for k, v in equal.items())
              + "; paired away " + ", ".join(f"{k} {v:.4f}"
                                             for k, v in paired.items()))
    fov_sum = base["fov_sum"]
    sum_norm = fov_sum / torch.max(fov_sum)
    den = denoise.denoise_nl_means(sum_norm, 0.02, 7, 11)
    b1 = float((denoise.denoise_nl_means(sum_norm, 0.021, 7, 11) - den)
               .abs().max())
    b2 = float((line_profile.lp_cv_enhance_2d(den, 11, 8)
                - line_profile.lp_cv_enhance_2d(den, 11, 9)).abs().max())
    print(f"on the slab FOV's inputs: B1 h 0.021 moves the denoised image "
          f"by up to {b1:.3e} (tol {TOL['nlm']:.0e}), B2 phi 8 the enhanced "
          f"image by up to {b2:.3e} (tol {TOL['lpcv2d']:.0e})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
