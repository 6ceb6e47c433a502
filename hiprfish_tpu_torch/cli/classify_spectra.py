"""7-bit spectra classification CLI, synthetic community (the port of
hiprfish_tpu/cli/classify_spectra.py, same flags, plus --device): -i the
normalised spectra (_avgint_norm.csv), -r classifier path (.npz, or the
.pkl name it stands for), or the reference's own 4-pickle UMAP stack
(``*_umap_transform_biofilm_7b.pkl`` beside its ``_svc``, ``_check_svc``
and ``_scaler`` pickles).
"""

from __future__ import annotations

import argparse
import os

from hiprfish_tpu_torch.cli import (add_device_flag, resolve_classifier_path,
                                    resolve_device)
from hiprfish_tpu_torch.models.artifacts import load_classifier
from hiprfish_tpu_torch.pipeline import classify


def main(argv=None):
    parser = argparse.ArgumentParser("Classify single cell spectra")
    parser.add_argument("-i", "--input_spectra", dest="input_spectra",
                        type=str, default="")
    parser.add_argument("-r", "--ref_clf", dest="ref_clf", type=str,
                        default="")
    add_device_flag(parser)
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    if args.ref_clf.endswith("transform_biofilm_7b.pkl") and os.path.exists(
            args.ref_clf):
        # the reference's own 4-pickle stack (classify_spectra.py:56-59)
        classify.classify_spectra_7b_legacy(args.input_spectra, args.ref_clf,
                                            device=device)
        return
    clf = load_classifier(resolve_classifier_path(args.ref_clf))
    classify.classify_spectra_7b(args.input_spectra, clf, device=device)


if __name__ == "__main__":
    main()
