"""The port never imports jax nor the JAX package: run its CPU slice in a
subprocess where any ``import jax`` or ``import hiprfish_tpu`` raises
(sys.modules[...] = None)."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import sys
sys.modules["jax"] = None
sys.modules["hiprfish_tpu"] = None
import pkgutil, importlib
import torch
torch.set_num_threads(1)
import hiprfish_tpu_torch
for m in pkgutil.walk_packages(hiprfish_tpu_torch.__path__,
                               "hiprfish_tpu_torch."):
    importlib.import_module(m.name)
from hiprfish_tpu_torch.config import SEVEN_BIT, SegmentationConfig
from hiprfish_tpu_torch.utils import synthetic
from hiprfish_tpu_torch.models.artifacts import load_classifier
from hiprfish_tpu_torch.pipeline import fused
fov = synthetic.make_fov(SEVEN_BIT, [1 + (i * 7) % 127 for i in range(9)],
                         shape=(160, 160), seed=1,
                         laser_shifts=[(0, 0), (2, -1), (0, 3), (-2, 0)],
                         cell_axes=(7.0, 12.0))
arrays, static = fused.classifier_from_numpy(load_classifier(sys.argv[1]))
res = fused.fov_step(tuple(torch.from_numpy(a) for a in fov["stack"]),
                     arrays, SegmentationConfig(), 32, static)
assert not {"jax", "hiprfish_tpu"} & {m.split(".")[0] for m in sys.modules
                                      if sys.modules[m] is not None}
print("cells", int(res.n_cells))
"""


def test_port_slice_runs_without_jax():
    fixture = os.path.join(ROOT, "tests", "fixtures",
                           "torch_port_clf_7b_127x50.npz")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", SCRIPT, fixture], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split("cells")[-1]) >= 7
