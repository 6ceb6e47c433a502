"""The port never imports jax nor the JAX package: import every module of
it and run its CPU slices (the 7-bit step; the 10-bit step, host engine
and measurement; the command lines, biofilm -d 2, -z and -d 3 and the
trainer among them, and the warm-up command) in a subprocess where any ``import jax`` or ``import hiprfish_tpu`` raises
(sys.modules[...] = None). The command lines run with pandas, matplotlib and imageio blocked
too, which the GPU machine does not have; the collectors and the workflow
driver as well, and a figure call then raises ImportError. The CZI readers
and the batch runner run with zstandard, PIL and imagecodecs blocked as
well (zstd then inflates through the system's libzstd). The legacy UMAP
classify routes run with sklearn, joblib, umap, pynndescent and numba
blocked as well."""

import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PREAMBLE = r"""
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
"""

SCRIPT = PREAMBLE + r"""
from hiprfish_tpu_torch.config import SEVEN_BIT, SegmentationConfig
from hiprfish_tpu_torch.utils import synthetic
from hiprfish_tpu_torch.models.artifacts import load_classifier
from hiprfish_tpu_torch.pipeline import fused
fov = synthetic.make_fov(SEVEN_BIT, [1 + (i * 7) % 127 for i in range(9)],
                         shape=(160, 160), seed=1,
                         laser_shifts=[(0, 0), (2, -1), (0, 3), (-2, 0)],
                         cell_axes=(7.0, 12.0))
arrays, static = fused.classifier_from_numpy(load_classifier(sys.argv[1]),
                                             "cpu")
res = fused.fov_step(tuple(torch.from_numpy(a) for a in fov["stack"]),
                     arrays, SegmentationConfig(), 32, static)
assert not {"jax", "hiprfish_tpu"} & {m.split(".")[0] for m in sys.modules
                                      if sys.modules[m] is not None}
print("cells", int(res.n_cells))
"""


SCRIPT_ECOLI = PREAMBLE + r"""
from hiprfish_tpu_torch.config import TEN_BIT, SegmentationConfig
from hiprfish_tpu_torch.utils import synthetic
from hiprfish_tpu_torch.models.artifacts import load_classifier
from hiprfish_tpu_torch.pipeline import fused, fused_ecoli, measure, segment2d
fov = synthetic.make_fov(TEN_BIT, [5, 37, 515, 1023, 96, 640, 17, 260, 770],
                         shape=(192, 192), seed=1,
                         laser_shifts=synthetic.ECOLI_SHIFTS,
                         cell_axes=synthetic.ECOLI_CELL_AXES)
stack = tuple(torch.from_numpy(a) for a in fov["stack"])
arrays, static = fused.classifier_from_numpy(load_classifier(sys.argv[1]),
                                             "cpu")
res = fused_ecoli.fov_step_ecoli(stack, arrays, SegmentationConfig(), 64,
                                 static)
host = segment2d.segment_ecoli(stack, SegmentationConfig(), 64)
avg, _ = measure.measure_fov(host.segmentation, host.registered,
                             host.n_cells, 64)
assert avg.shape == (int(host.n_cells), 95)
assert not {"jax", "hiprfish_tpu"} & {m.split(".")[0] for m in sys.modules
                                      if sys.modules[m] is not None}
print("cells", int(res.n_cells), int(host.n_cells))
"""


SCRIPT_CLI = r"""
import sys
for name in ("pandas", "matplotlib", "imageio"):
    sys.modules[name] = None
""" + PREAMBLE + r"""
import os
import numpy as np
from hiprfish_tpu_torch.config import SEVEN_BIT, TEN_BIT
from hiprfish_tpu_torch.utils import synthetic
from hiprfish_tpu_torch.cli import (classify, classify_spectra, measure,
                                    measure_multispecies)
fixtures = os.path.dirname(sys.argv[1])
os.chdir(sys.argv[2])
runs = (
    (TEN_BIT, [5, 37, 515, 1023, 96, 640, 17, 260, 770],
     ("405", "488", "514", "561", "633"), synthetic.ECOLI_SHIFTS, (9.0, 14.0),
     "ten_enc_5"),
    (SEVEN_BIT, [1, 9, 65, 127, 34, 88], ("488", "514", "561", "633"), None,
     (7.0, 12.0), "seven"),
)
for layout, codes, lasers, shifts, axes, sample in runs:
    fov = synthetic.make_fov(layout, codes, shape=(192, 192), seed=1,
                             laser_shifts=shifts, cell_axes=axes)
    names = [f"{sample}_{laser}.npy" for laser in lasers]
    for name, plane in zip(names, fov["stack"]):
        np.save(name, plane)
    if layout is TEN_BIT:
        measure.main(["-i", *names, "-c", "F", "--max_cells", "64",
                      "--device", "cpu"])
        classify.main([f"{sample}_avgint.csv", "-rf",
                       os.path.join(fixtures, "torch_port_clf_10b_1023x200.npz"),
                       "--device", "cpu"])
        suffixes = ("_avgint.csv", "_avgint_norm.csv", "_seg.npy", "_seg.png",
                    "_cell_ids.txt", "_avgint_ids.csv", "_identification.png")
    else:
        measure_multispecies.main(["-i", *names, "--max_cells", "64",
                                   "--device", "cpu"])
        classify_spectra.main([
            "-i", f"{sample}_avgint_norm.csv", "-r",
            os.path.join(fixtures, "torch_port_clf_7b_127x50.npz"),
            "--device", "cpu"])
        suffixes = ("_seg.npy", "_registered.npy", "_avgint_norm.csv",
                    "_seg.png", "_sum.png", "_enhanced.png",
                    "_cell_information.csv")
    for suffix in suffixes:
        assert os.path.getsize(sample + suffix) > 0, sample + suffix
blocked = {"jax", "hiprfish_tpu", "pandas", "matplotlib", "imageio"}
assert not blocked & {m.split(".")[0] for m in sys.modules
                      if sys.modules[m] is not None}
print("cells", len(open("ten_enc_5_cell_ids.txt").read().split()),
      len(open("seven_cell_information.csv").read().splitlines()))
"""


SCRIPT_BIOFILM = r"""
import sys
for name in ("pandas", "matplotlib", "imageio"):
    sys.modules[name] = None
""" + PREAMBLE + r"""
import os
import numpy as np
from hiprfish_tpu_torch.config import SEVEN_BIT
from hiprfish_tpu_torch.utils import synthetic
from hiprfish_tpu_torch.cli import biofilm
codes = [1, 9, 65, 127, 34, 88]
os.chdir(sys.argv[2])
with open("probes.csv", "w") as f:
    f.write("target_taxon,code\n")
    f.writelines(f"{100 + i},{SEVEN_BIT.code_str(c)}\n"
                 for i, c in enumerate(codes))
os.makedirs("fov")
os.makedirs("zstack")
fov = synthetic.make_fov(SEVEN_BIT, codes, shape=(192, 192), seed=5,
                         cell_axes=(7.0, 12.0))
for laser, plane in zip(SEVEN_BIT.lasers, fov["stack"]):
    np.save(f"fov/s_{laser}.npy", plane)
    np.save(f"zstack/z_{laser}.npy", np.stack([0.8 * plane, plane]))
flags = ["-p", "probes.csv", "-r", sys.argv[1], "--max_cells", "64",
         "--device", "cpu"]
biofilm.main(["fov", *flags, "-d", "2"])
biofilm.main(["zstack", *flags, "-z", "1"])
for name in ("fov/s_seg.npy", "fov/s_adjacency_matrix.csv",
             "fov/s_identification.png", "fov/taxon_color_lookup.csv",
             "zstack/z_z_1_seg.npy", "zstack/z_z_1_cell_information.csv"):
    assert os.path.getsize(name) > 0, name
blocked = {"jax", "hiprfish_tpu", "pandas", "matplotlib", "imageio"}
assert not blocked & {m.split(".")[0] for m in sys.modules
                      if sys.modules[m] is not None}
print("cells", len(open("fov/s_cell_information.csv").read().splitlines()) - 1,
      len(open("zstack/z_z_1_cell_information.csv").read().splitlines()))
"""


SCRIPT_BIOFILM_3D = r"""
import sys
for name in ("pandas", "matplotlib", "imageio"):
    sys.modules[name] = None
""" + PREAMBLE + r"""
import os
import numpy as np
from hiprfish_tpu_torch.config import SEVEN_BIT
from hiprfish_tpu_torch.utils import synthetic, synthetic3d
from hiprfish_tpu_torch.cli import biofilm
os.chdir(sys.argv[2])
spec = synthetic3d.VolumeSpec(shape=(96, 72, 40), spacing=(32, 24, 40),
                              seed=3)
codes = synthetic3d.node_codes(spec, 127) + 1
lut = torch.from_numpy(np.stack([synthetic.barcode_spectrum(SEVEN_BIT, c)
                                 for c in range(1, 128)]).astype(np.float32))
cube = synthetic3d.channel_chunk_cm(spec, 127, 0, 40, lut, 1) \
    .permute(1, 2, 3, 0).numpy()
with open("probes.csv", "w") as f:
    f.write("target_taxon,code\n")
    f.writelines(f"{100 + i},{SEVEN_BIT.code_str(int(c))}\n"
                 for i, c in enumerate(codes))
os.makedirs("stacks")
for laser, (lo, hi) in zip(SEVEN_BIT.lasers, SEVEN_BIT.blocks):
    np.save(f"stacks/v_{laser}.npy", np.ascontiguousarray(cube[..., lo:hi]))
biofilm.main(["stacks", "-p", "probes.csv", "-r", sys.argv[1], "-d", "3",
              "--max_cells", "64", "--device", "cpu"])
for name in ("v_seg.npy", "v_registered.npy", "v_identification.npy",
             "v_raw_image.bvox", "v_identification_b.bvox",
             "v_cell_information.csv"):
    assert os.path.getsize("stacks/" + name) > 0, name
blocked = {"jax", "hiprfish_tpu", "pandas", "matplotlib", "imageio"}
assert not blocked & {m.split(".")[0] for m in sys.modules
                      if sys.modules[m] is not None}
print("cells", len(open("stacks/v_cell_information.csv").read()
                   .splitlines()) - 1)
"""


SCRIPT_TRAIN = r"""
import sys
for name in ("pandas", "matplotlib", "imageio"):
    sys.modules[name] = None
""" + PREAMBLE + r"""
import os
from hiprfish_tpu_torch.config import SEVEN_BIT, TEN_BIT
from hiprfish_tpu_torch.utils import synthetic
from hiprfish_tpu_torch.cli import train
from hiprfish_tpu_torch.models.artifacts import load_classifier
os.chdir(sys.argv[2])
synthetic.write_reference_folder(TEN_BIT, "ref", [5, 37, 515, 96, 640],
                                 cells_per_code=20, seed=0, write_norm=True)
synthetic.write_reference_folder(TEN_BIT, "ref", [512, 128, 64, 32, 4, 2, 1],
                                 cells_per_code=20, seed=3)
with open("probes.csv", "w") as f:
    f.write("target_taxon,code\n100,0000011\n101,1000001\n")
with open("mix_2.csv", "w") as f:
    f.write("Barcodes\n5\n37\n")
flags = ["--device", "cpu"]
train.main(["ref", "-v", "violet_derivative", "-s", "20", *flags])
train.main(["ref", "-v", "fret_biofilm_7b", "-s", "10", "-p", "probes.csv",
            *flags])
train.main(["ref", "-v", "select", "-s", "20", "-t", "mix_2.csv", *flags])
names = sorted(n for n in os.listdir("ref") if n.endswith(".npz"))
assert len(names) == 3, names
blocked = {"jax", "hiprfish_tpu", "pandas", "matplotlib", "imageio"}
assert not blocked & {m.split(".")[0] for m in sys.modules
                      if sys.modules[m] is not None}
print("cells", *(len(load_classifier("ref/" + n).codebook) for n in names))
"""


SCRIPT_COLLECT = r"""
import sys
for name in ("pandas", "matplotlib", "imageio"):
    sys.modules[name] = None
""" + PREAMBLE + r"""
import json
import os
import numpy as np
from hiprfish_tpu_torch.config import TEN_BIT
from hiprfish_tpu_torch.utils import synthetic
from hiprfish_tpu_torch.cli import collect, workflow
from hiprfish_tpu_torch.pipeline import summarize
os.chdir(sys.argv[2])
os.makedirs("data/fovs")
os.makedirs("data/ref")
os.symlink(sys.argv[1], "data/ref/reference_simulate_200_excitation_adjusted"
           "_normalized_violet_derivative_umap_transform.npz")
with open("images_table.csv", "w") as f:
    f.write("SAMPLE,IMAGES,CALIBRATION,CALIBRATION_FILENAME,"
            "REFERENCE_FOLDER,SPC\n")
    for enc in (5, 37):
        fov = synthetic.make_fov(TEN_BIT, [enc] * 4, shape=(128, 128),
                                 seed=enc, laser_shifts=synthetic.ECOLI_SHIFTS,
                                 cell_axes=synthetic.ECOLI_CELL_AXES)
        for laser, plane in zip(TEN_BIT.lasers, fov["stack"]):
            np.save(f"data/fovs/w_enc_{enc}_{laser}.npy", plane)
        f.write(f"fovs,w_enc_{enc},F,none,ref,200\n")
with open("config.json", "w") as f:
    json.dump({"__default__": {"DATA_DIR": "data"},
               "images": {"image_list_table": "images_table.csv",
                          "image_type": "R"}}, f)
log = workflow.main(["config.json", "--max_cells", "64", "--device", "cpu"])
assert log.summary()["classify"]["count"] == 2
results = open("images_table_results.csv").read().splitlines()
collect.main(["data", "images_table.csv", "again_results.csv", "-t", "R"])
assert open("again_results.csv").read().splitlines() == results
os.rename("data/fovs/w_enc_5_cell_ids.txt", "data/fovs/mix_1_fov_1_cell_ids.txt")
os.rename("data/fovs/w_enc_37_cell_ids.txt", "data/fovs/mix_1_fov_2_cell_ids.txt")
with open("images_table_mix_1.csv", "w") as f:
    f.write("SAMPLE,IMAGES\nfovs,mix_1_fov_1\nfovs,mix_1_fov_2\n")
collect.main(["data", "images_table_mix_1.csv",
              "images_table_mix_1_results.csv", "-t", "M"])
with open("images_table_mix_1.csv", "w") as f:
    f.write("Barcodes,InputConcentration\n5,1.0\n37,2.0\n96,0.0\n")
res = summarize.titration_correlation("images_table_mix_*_results_abundance.csv")
try:
    summarize.plot_mean_abundance_barcodes(
        "images_table_mix_1_results_abundance.csv", "a.pdf")
    raise AssertionError("a figure without matplotlib")
except ImportError:
    pass
blocked = {"jax", "hiprfish_tpu", "pandas", "matplotlib", "imageio"}
assert not blocked & {m.split(".")[0] for m in sys.modules
                      if sys.modules[m] is not None}
counts = [int(float(v)) for v in
          open("images_table_mix_1_results_abundance.csv").read()
          .splitlines()[5].split(",")[1:]]
print("cells", *[r.split(",")[6] for r in results[1:]], *counts,
      res["gross_error_rate"])
"""


SCRIPT_READERS = r"""
import sys
for name in ("pandas", "matplotlib", "imageio", "zstandard", "PIL",
             "imagecodecs"):
    sys.modules[name] = None
""" + PREAMBLE + r"""
import os
import numpy as np
from hiprfish_tpu_torch.config import SEVEN_BIT
from hiprfish_tpu_torch.io import czi
from hiprfish_tpu_torch.models.artifacts import load_classifier
from hiprfish_tpu_torch.parallel import fov_batch
from hiprfish_tpu_torch.utils import synthetic
os.chdir(sys.argv[2])
with czi.CziFile(sys.argv[3]) as f:
    zplane = f.load_plane_python()
assert np.array_equal(zplane, np.load(sys.argv[4]))
samples = []
for i, (pixel_type, comp) in enumerate(((2, czi.COMP_UNCOMPRESSED),
                                        (1, czi.COMP_JPEGXR))):
    fov = synthetic.make_fov(SEVEN_BIT, [1, 9, 65, 127], shape=(96, 96),
                             seed=i, cell_axes=(6.0, 9.0))
    files = []
    for laser, plane in zip(SEVEN_BIT.lasers, fov["stack"]):
        files.append(f"s{i}_{laser}.czi")
        data = plane if pixel_type == 2 else np.clip(
            np.round(plane * 65535), 0, 65535).astype(np.uint16)
        czi.write_czi(files[-1], data, pixel_type=pixel_type,
                      compression=comp)
        with czi.CziFile(files[-1]) as f:
            got = f.load_plane()
        want = data if pixel_type == 2 else data.astype(np.float32) / 65535
        assert np.array_equal(got, want), files[-1]
    samples.append((f"s{i}", files))
res = fov_batch.run_batch_pipeline(samples, load_classifier(sys.argv[1]),
                                   max_cells=32, device="cpu")
blocked = {"jax", "hiprfish_tpu", "pandas", "matplotlib", "imageio",
           "zstandard", "PIL", "imagecodecs"}
assert not blocked & {m.split(".")[0] for m in sys.modules
                      if sys.modules[m] is not None}
print("cells", *(res[k][0] for k in ("s0", "s1")))
"""


SCRIPT_LEGACY = r"""
import sys
for name in ("pandas", "matplotlib", "imageio", "sklearn", "joblib", "umap",
             "pynndescent", "numba"):
    sys.modules[name] = None
""" + PREAMBLE + r"""
import os
import numpy as np
from hiprfish_tpu_torch.cli import classify, classify_spectra
from hiprfish_tpu_torch.io import outputs
stacks = sys.argv[1]
answers = np.load(os.path.join(stacks, "answers.npz"))
os.chdir(sys.argv[2])
calls = []
for tag in ("10b", "7b"):
    q = answers[f"queries_{tag}"]
    seg = np.zeros((8, 8 * len(q)), np.int32)
    for i in range(len(q)):
        seg[2:6, 8 * i + 2:8 * i + 6] = i + 1
    if tag == "10b":
        np.savetxt("s10_avgint.csv", q[:, :95], delimiter=",")
        np.save("s10_seg.npy", seg)
        classify.main(["s10_avgint.csv", "-rf",
                       os.path.join(stacks, "ref10_umap_transform.pkl"),
                       "--device", "cpu"])
        got = open("s10_cell_ids.txt").read().split()
        for suffix in ("_avgint_ids.csv", "_identification.png"):
            assert os.path.getsize("s10" + suffix) > 0, suffix
    else:
        outputs.save_avgint_norm_csv_with_header("s7_avgint_norm.csv",
                                                 q[:, :63])
        np.save("s7_seg.npy", seg)
        classify_spectra.main([
            "-i", "s7_avgint_norm.csv", "-r",
            os.path.join(stacks, "ref7_umap_transform_biofilm_7b.pkl"),
            "--device", "cpu"])
        got = [r.split(",")[67] for r in
               open("s7_cell_information.csv").read().splitlines()]
    calls.append(float(np.mean(np.array(got) == answers[f"labels_{tag}"])))
blocked = {"jax", "hiprfish_tpu", "pandas", "matplotlib", "imageio",
           "sklearn", "joblib", "umap", "pynndescent", "numba"}
assert not blocked & {m.split(".")[0] for m in sys.modules
                      if sys.modules[m] is not None}
print("cells", *calls)
"""


SCRIPT_WARMUP = PREAMBLE + r"""
import contextlib, io
from hiprfish_tpu_torch.cli import warmup
err = io.StringIO()
with contextlib.redirect_stderr(err):
    rc = warmup.main(["--family", "ecoli", "multispecies", "3d", "--size",
                      "64", "--device", "cpu"])
assert rc == 0 and "warmup complete" in err.getvalue(), err.getvalue()
assert not {"jax", "hiprfish_tpu"} & {m.split(".")[0] for m in sys.modules
                                      if sys.modules[m] is not None}
print("cells", err.getvalue().count("# "))
"""


def _run(script, fixture_name, *args):
    fixture = os.path.join(ROOT, "tests", "fixtures", fixture_name)
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", script, fixture, *args],
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout.split("cells")[-1].split()


def test_port_slice_runs_without_jax():
    out = _run(SCRIPT, "torch_port_clf_7b_127x50.npz")
    assert int(out[0]) >= 7


def test_port_ecoli_slice_runs_without_jax():
    out = _run(SCRIPT_ECOLI, "torch_port_clf_10b_1023x200.npz")
    n_fused, n_host = (int(v) for v in out)
    assert n_fused == n_host == 9


def test_port_clis_run_without_jax_pandas_matplotlib(tmp_path):
    out = _run(SCRIPT_CLI, "torch_port_clf_10b_1023x200.npz", str(tmp_path))
    n_ten, n_seven = (int(v) for v in out)
    assert n_ten == 9 and n_seven == 6


def test_port_biofilm_cli_runs_without_jax_pandas_matplotlib(tmp_path):
    out = _run(SCRIPT_BIOFILM, "torch_port_clf_7b_127x50.npz", str(tmp_path))
    n_fov, n_slice = (int(v) for v in out)
    assert n_fov == n_slice == 6


def test_port_biofilm_3d_cli_runs_without_jax_pandas_matplotlib(tmp_path):
    out = _run(SCRIPT_BIOFILM_3D, "torch_port_clf_7b_127x50.npz",
               str(tmp_path))
    assert int(out[0]) == 9


def test_port_collect_and_workflow_run_without_jax_pandas_matplotlib(
        tmp_path):
    # cli.workflow on two 128^2 reference FOVs of four cells each, then
    # cli.collect -t R and -t M and titration_correlation on its calls;
    # barcode 5 (row 5 of the abundance table) holds FOV 1's four cells
    out = _run(SCRIPT_COLLECT, "torch_port_clf_10b_1023x200.npz",
               str(tmp_path))
    assert out == ["4", "4", "4", "0", "0.0"]


def test_port_trainer_runs_without_jax_pandas_matplotlib(tmp_path):
    # cli.train's violet-derivative, FRET (probe design) and mix-table
    # variants; the artifacts in name order: reference_simulate_10_DSGN_...
    # (2 codes), reference_simulate_20_... (12 codes), ..._select_mix_2_...
    out = _run(SCRIPT_TRAIN, "torch_port_clf_7b_127x50.npz", str(tmp_path))
    assert [int(v) for v in out] == [2, 12, 2]


def test_port_readers_and_batch_run_without_zstandard_pil(tmp_path):
    # a zstd plane written here (with zstandard) and read in the
    # subprocess by the Python parser through libzstd, then two 96^2 FOVs
    # as Gray32Float and Gray16 JPEG-XR .czi through run_batch_pipeline
    from hiprfish_tpu_torch.io import czi

    plane = np.random.RandomState(4).rand(20, 24, 3).astype(np.float32)
    np.save(tmp_path / "zplane.npy", plane)
    czi.write_czi(str(tmp_path / "zplane.czi"), plane,
                  compression=czi.COMP_ZSTD0)
    out = _run(SCRIPT_READERS, "torch_port_clf_7b_127x50.npz", str(tmp_path),
               str(tmp_path / "zplane.czi"), str(tmp_path / "zplane.npy"))
    assert all(int(v) >= 3 for v in out) and len(out) == 2


def test_port_legacy_classify_routes_run_without_sklearn_joblib(tmp_path):
    # both legacy routes on the committed real-sklearn stacks
    # (tools/make_torch_legacy_fixture.py) with sklearn, joblib, umap,
    # pynndescent, numba and pandas blocked: the held-out calls
    out = _run(SCRIPT_LEGACY, "legacy_stacks", str(tmp_path))
    assert [float(v) for v in out] == [1.0, 1.0]


def test_port_warmup_runs_without_jax():
    # the three families at 64^2 on the CPU and the closing line
    out = _run(SCRIPT_WARMUP, "torch_port_clf_7b_127x50.npz")
    assert int(out[0]) == 4
