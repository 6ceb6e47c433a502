"""Build tests/fixtures/torch_port_clf_7b_127x50.npz: the 127-code 7-bit
classifier of the headline benchmark, trained by the JAX package.

The recipe is bench.py's (50 simulated rows per code, RandomState(0),
check_train_steps=300, PRNGKey(0)). The committed file lets the CPU parity
tests and chip_smoke.py use the same weights; the machine with the GPU has
no jax to train them. Run from the repository root:

    JAX_PLATFORMS=cpu python tools/make_torch_port_fixture.py
"""

from __future__ import annotations

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "fixtures", "torch_port_clf_7b_127x50.npz")


def build(path: str = OUT) -> str:
    import jax

    from hiprfish_tpu.config import SEVEN_BIT, ClassifierConfig
    from hiprfish_tpu.models import train as mtrain
    from hiprfish_tpu.models.artifacts import save_classifier
    from hiprfish_tpu.models.classifier import train_classifier
    from hiprfish_tpu.utils import synthetic

    layout = SEVEN_BIT
    rng = np.random.RandomState(0)
    spectra_lut = synthetic.fluorophore_spectra(layout)
    rows, code_strs = [], []
    for c in range(1, 128):
        spec = synthetic.barcode_spectrum(layout, c, spectra_lut)
        r = rng.uniform(0.7, 1.3, (50, 1)) * spec[None, :] \
            + rng.randn(50, layout.n_channels) * 0.02
        rows.append(np.clip(r, 0, None))
        code_strs += [layout.code_str(c)] * 50
    spectra = np.concatenate(rows).astype(np.float32)
    spectra = spectra / np.maximum(spectra.max(axis=1, keepdims=True), 1e-12)
    checks = mtrain.check_bits_for_codes(layout, code_strs)
    clf = train_classifier(jax.random.PRNGKey(0), layout, spectra,
                           code_strs, checks,
                           ClassifierConfig(check_train_steps=300))
    save_classifier(path, clf)
    return path


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    print(build(sys.argv[1] if len(sys.argv) > 1 else OUT))
