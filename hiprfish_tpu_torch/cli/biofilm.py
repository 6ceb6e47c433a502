"""Biofilm analysis CLI (the port of hiprfish_tpu/cli/biofilm.py, same
flags, plus --device): positional input folder; -p probe-design CSV; -r
classifier path (.npz, or the .pkl name it stands for); -d 2 for the 2D
analysis of each FOV; -z <z ...> for the z-slice analysis of each z-stack;
otherwise (-d 3) the volumetric analysis of each z-stack; -sf T when the
folder holds one subfolder per dataset; --max_cells.

Each sample is the name of a set of per-laser files '<sample>_<laser>.npy'
in the folder ('.czi' inputs raise: ROADMAP §A.7).
"""

from __future__ import annotations

import argparse
import glob
import os
import re

from hiprfish_tpu_torch.cli import (add_device_flag, resolve_classifier_path,
                                    resolve_device)
from hiprfish_tpu_torch.io import tables
from hiprfish_tpu_torch.models.artifacts import load_classifier
from hiprfish_tpu_torch.pipeline import biofilm, segment3d

_LASER_SUFFIX = r"_[0-9][0-9][0-9]?\.(czi|npy)$"


def samples_in(folder: str) -> list:
    """The sorted sample names of the per-laser files in a folder."""
    files = glob.glob(f"{folder}/*.czi") + glob.glob(f"{folder}/*.npy")
    return sorted({re.sub(_LASER_SUFFIX, "", f) for f in files
                   if re.search(_LASER_SUFFIX, f)})


def main(argv=None):
    parser = argparse.ArgumentParser(
        "Measure environmental microbial community spectral images")
    parser.add_argument("input_folder", type=str)
    parser.add_argument("-p", "--probe_design_filename",
                        dest="probe_design_filename", type=str, default="")
    parser.add_argument("-r", "--ref_clf", dest="ref_clf", type=str,
                        default="")
    parser.add_argument("-d", "--d", dest="d", type=int,
                        help="Dimension of images")
    parser.add_argument("-z", "--z", dest="z", nargs="*", type=int,
                        help="Indices of z slices to analyze")
    parser.add_argument("-sf", "--sf", dest="sf", type=str,
                        help="Dataset contains subfolders")
    parser.add_argument("--max_cells", type=int, default=4096)
    add_device_flag(parser)
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    taxon_lookup = biofilm.make_taxon_lookup(
        tables.read_probe_design(args.probe_design_filename))
    taxon_lookup.save(os.path.join(args.input_folder,
                                   "taxon_color_lookup.csv"))
    clf = load_classifier(resolve_classifier_path(args.ref_clf))

    folders = (glob.glob(f"{args.input_folder}/*") if args.sf == "T"
               else [args.input_folder])
    for folder in folders:
        if args.sf == "T" and "zstack" in folder:
            continue
        for s in samples_in(folder):
            if args.d == 2:
                biofilm.measure_biofilm_images_2d(
                    s, clf, taxon_lookup, max_cells=args.max_cells,
                    device=device)
            elif args.z is not None:
                segment3d.measure_biofilm_images_2d_from_zstack_cli(
                    s, clf, taxon_lookup, args.z, max_cells=args.max_cells,
                    device=device)
            else:
                segment3d.measure_biofilm_images_3d(
                    s, clf, taxon_lookup, max_cells=args.max_cells,
                    device=device)


if __name__ == "__main__":
    main()
