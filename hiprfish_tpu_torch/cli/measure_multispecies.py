"""Synthetic-community (multispecies) spectral image measurement CLI (the
port of hiprfish_tpu/cli/measure_multispecies.py, same flags, plus
--device): -i per-laser image filenames, -c calibration image filename.
Writes {sample}_seg.npy, _registered.npy, _avgint_norm.csv (with a header
row), _seg.png, _sum.png, _enhanced.png.

The engine is pipeline/segment2d.segment_lpcv: kernels B1 (NL-means) and
B2 (LP-CV) on the card, their plain versions on the CPU.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from hiprfish_tpu_torch.cli import add_device_flag, resolve_device
from hiprfish_tpu_torch.cli.measure import load_stack
from hiprfish_tpu_torch.config import SegmentationConfig
from hiprfish_tpu_torch.io import images as iio
from hiprfish_tpu_torch.io import outputs, tables
from hiprfish_tpu_torch.pipeline import measure, segment2d


def measure_biofilm_images_no_reference(image_names, calibration="",
                                        cfg=SegmentationConfig(),
                                        max_cells=4096,
                                        device=torch.device("cuda")):
    """Segment and measure one FOV and write its artifacts into the
    current directory. Returns the Segmentation2D."""
    device = torch.device(device)
    sample = tables.sample_from_image_name(image_names[0])
    stack = load_stack(image_names, device)
    cal = None
    if calibration:
        cal = torch.from_numpy(iio.load_calibration_image(calibration)) \
            .to(device)
    res = segment2d.segment_lpcv(stack, cal, cfg, max_cells, "multispecies")
    n = int(res.n_cells)
    _, avgint_norm = measure.measure_fov(
        res.segmentation, res.registered, n, max_cells)
    seg = res.segmentation.cpu().numpy()
    np.save(f"{sample}_seg.npy", seg)
    np.save(f"{sample}_registered.npy", res.registered.cpu().numpy())
    outputs.save_avgint_norm_csv_with_header(
        f"{sample}_avgint_norm.csv", avgint_norm)
    outputs.save_segmentation(seg, sample)
    outputs.save_sum_png(res.fov_sum.cpu().numpy(), sample)
    outputs.save_sum_png(res.enhanced.cpu().numpy(), sample,
                         "_enhanced.png")
    return res


def main(argv=None):
    parser = argparse.ArgumentParser(
        "Measure multispecies synthetic spectral images")
    parser.add_argument("-i", "--image_name", dest="image_name", nargs="*",
                        default=[], type=str)
    parser.add_argument("-c", "--calibration", dest="calibration", type=str,
                        default="")
    parser.add_argument("--max_cells", type=int, default=4096)
    add_device_flag(parser)
    args = parser.parse_args(argv)
    measure_biofilm_images_no_reference(
        args.image_name, args.calibration, max_cells=args.max_cells,
        device=resolve_device(args.device))


if __name__ == "__main__":
    main()
