"""E. coli reference/mix spectral image measurement CLI (the port of
hiprfish_tpu/cli/measure.py, same flags, plus --device):
  -i  per-laser image filenames (.npy / .tif)
  -c  calibration toggle ('T'/'F')
  -cf calibration image filename (.npy)
Writes {sample}_avgint.csv, _avgint_norm.csv, _seg.npy, _seg.png.

On the card it runs the single-pass engine
pipeline/fused_ecoli.segment_ecoli_device (kernels B3 and B4, a bf16
registered cube), as the reference does on its accelerator; on the CPU
the host engine pipeline/segment2d.segment_ecoli (float32 cube).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from hiprfish_tpu_torch.cli import add_device_flag, resolve_device
from hiprfish_tpu_torch.config import TEN_BIT, SegmentationConfig
from hiprfish_tpu_torch.io import images as iio
from hiprfish_tpu_torch.io import tables
from hiprfish_tpu_torch.pipeline import fused_ecoli, measure, segment2d


def load_stack(image_names, device) -> tuple:
    """Per-laser planes as float32 tensors on ``device``."""
    return tuple(torch.from_numpy(np.ascontiguousarray(a, np.float32))
                 .to(device) for a in iio.load_image_stack(image_names))


def measure_reference_images(image_names, cal_toggle="F",
                             calibration_filename="",
                             cfg=SegmentationConfig(), max_cells=4096,
                             device=torch.device("cuda"), engine=None):
    """Segment and measure one FOV and write its artifacts into the
    current directory. ``engine``: "fused", "host", or None for fused on
    a CUDA device and host on the CPU. Returns (segmentation, avgint)."""
    device = torch.device(device)
    if engine is None:
        engine = "fused" if device.type == "cuda" else "host"
    if engine not in ("fused", "host"):
        raise ValueError(f"engine must be 'fused', 'host' or None, got "
                         f"{engine!r}")
    sample = tables.sample_from_image_name(image_names[0])
    print(f"Analyzing sample {sample}...")
    stack = load_stack(image_names, device)
    if engine == "fused":
        seg, n_cells, registered, _ = fused_ecoli.segment_ecoli_device(
            stack, cfg, max_cells)
        res = segment2d.Segmentation2D(
            seg, n_cells, registered,
            torch.sum(registered, dim=2, dtype=torch.float32),
            torch.zeros(seg.shape, device=device), torch.zeros_like(seg),
            torch.zeros(seg.shape, dtype=torch.bool, device=device))
    else:
        res = segment2d.segment_ecoli(stack, cfg, max_cells)
    registered = res.registered
    if cal_toggle == "T" and not calibration_filename:
        # -c defaults to 'T' with an empty -cf: degrade to uncalibrated
        print("calibration requested but no -cf file given; skipping")
        cal_toggle = "F"
    if cal_toggle == "T":
        cal = iio.load_calibration_image(calibration_filename)
        cal_cube = iio.build_calibration_cube(
            cal, registered.shape[2], TEN_BIT.block_bounds[1])
        # a bf16 cube divided by the f32 calibration gives f32
        registered = registered / torch.from_numpy(cal_cube).to(device)
    n = int(res.n_cells)
    avgint, avgint_norm = measure.measure_fov(
        res.segmentation, registered, n, max_cells)
    measure.save_measurement(sample, avgint, avgint_norm,
                             res.segmentation.cpu().numpy())
    return res.segmentation, avgint


def main(argv=None):
    parser = argparse.ArgumentParser(
        "Measure HiPR-FISH reference spectral images")
    parser.add_argument("-i", "--image_name", dest="image_name", nargs="*",
                        default=[], type=str, help="Image filenames")
    parser.add_argument("-c", "--calibration", dest="cal_toggle", type=str,
                        default="T", help="Flat-field calibration toggle")
    parser.add_argument("-cf", "--calibration_images_filename",
                        dest="calibration_images_filename", type=str,
                        default="", help="Calibration image filename")
    parser.add_argument("--max_cells", type=int, default=4096)
    add_device_flag(parser)
    args = parser.parse_args(argv)
    measure_reference_images(
        args.image_name, args.cal_toggle, args.calibration_images_filename,
        max_cells=args.max_cells, device=resolve_device(args.device))


if __name__ == "__main__":
    main()
