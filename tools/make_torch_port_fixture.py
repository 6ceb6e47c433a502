"""Build the classifier fixtures of the PyTorch port, trained by the JAX
package:

* tests/fixtures/torch_port_clf_7b_127x50.npz: the 127-code 7-bit
  classifier of the headline benchmark (bench.py's recipe: 50 simulated rows
  per code, RandomState(0), check_train_steps=300, PRNGKey(0));
* tests/fixtures/torch_port_clf_10b_1023x200.npz: the 1023-class 10-bit
  classifier of bench.py's 10-bit configuration (bench_ecoli_10bit: 200
  rows per code, gains drawn before noise, row-max normalisation, the
  violet derivative of the first 32 channels appended, 6 check heads,
  8 kNN prototypes per class = an 8,184-row kNN matrix).

The committed files let the CPU parity tests and chip_smoke.py use the same
weights; the machine with the GPU has no jax to train them. Run from the
repository root:

    JAX_PLATFORMS=cpu python tools/make_torch_port_fixture.py [7b|10b] [OUT]

With no argument both fixtures are built.
"""

from __future__ import annotations

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
OUT = os.path.join(FIXTURES, "torch_port_clf_7b_127x50.npz")
OUT_10B = os.path.join(FIXTURES, "torch_port_clf_10b_1023x200.npz")


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


def build_10b(path: str = OUT_10B, spc: int = 200) -> str:
    """bench.py's bench_ecoli_10bit training recipe, line for line."""
    import jax

    from hiprfish_tpu.config import TEN_BIT, ClassifierConfig
    from hiprfish_tpu.models import train as mtrain
    from hiprfish_tpu.models.artifacts import save_classifier
    from hiprfish_tpu.models.classifier import train_classifier
    from hiprfish_tpu.utils import synthetic

    layout = TEN_BIT
    rng = np.random.RandomState(0)
    all_codes = list(range(1, 1024))
    lut = synthetic.fluorophore_spectra(layout)
    base = np.stack([synthetic.barcode_spectrum(layout, c, lut)
                     for c in all_codes])                      # (1023, 95)
    gains = rng.uniform(0.7, 1.3, (1023, spc, 1)).astype(np.float32)
    noise = rng.randn(1023, spc, layout.n_channels).astype(np.float32) \
        * 0.02
    spectra = np.clip(gains * base[:, None, :] + noise, 0, None)
    spectra = spectra.reshape(1023 * spc, layout.n_channels)
    spectra /= np.maximum(spectra.max(axis=1, keepdims=True), 1e-12)
    spectra = np.concatenate(
        [spectra, np.diff(spectra[:, :32], axis=1)], axis=1)
    code_strs = [layout.code_str(c) for c in all_codes for _ in range(spc)]
    checks = mtrain.check_bits_for_codes(layout, code_strs)
    clf = train_classifier(
        jax.random.PRNGKey(0), layout, spectra, code_strs, checks,
        ClassifierConfig(check_train_steps=300), violet_derivative=True)
    save_classifier(path, clf)
    return path


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    which = sys.argv[1] if len(sys.argv) > 1 else "all"
    out = sys.argv[2] if len(sys.argv) > 2 else None
    if which in ("7b", "all"):
        print(build(out or OUT))
    if which in ("10b", "all"):
        print(build_10b(out or OUT_10B))
