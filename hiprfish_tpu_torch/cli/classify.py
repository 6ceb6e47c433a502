"""E. coli spectral classification CLI, 10-bit / 1023 barcodes (the port
of hiprfish_tpu/cli/classify.py, same flags, plus --device): positional
input_spectra (the _avgint.csv), -rf classifier path (.npz, or the .pkl
name it stands for). The reference's 3-pickle UMAP stack is not ported yet
(ROADMAP §A.8) and raises.
"""

from __future__ import annotations

import argparse
import os

from hiprfish_tpu_torch.cli import (add_device_flag, resolve_classifier_path,
                                    resolve_device)
from hiprfish_tpu_torch.models.artifacts import load_classifier
from hiprfish_tpu_torch.pipeline import classify


def main(argv=None):
    parser = argparse.ArgumentParser("Classify HiPR-FISH cell spectra")
    parser.add_argument("input_spectra", type=str,
                        help="Average single-cell spectra filename "
                             "(_avgint.csv)")
    parser.add_argument("-rf", "--reference_clf", dest="ref_clf", type=str,
                        default="", help="Spectra classifier path")
    add_device_flag(parser)
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    print(f"Classifying sample {args.input_spectra}...")
    if args.ref_clf.endswith("transform.pkl") and os.path.exists(
            args.ref_clf):
        raise NotImplementedError(
            f"{args.ref_clf}: the reference's 3-pickle UMAP classifier is "
            "not ported yet (ROADMAP §A.8); pass the .npz artifact")
    clf = load_classifier(resolve_classifier_path(args.ref_clf))
    classify.classify_ecoli(args.input_spectra, clf, device=device)


if __name__ == "__main__":
    main()
