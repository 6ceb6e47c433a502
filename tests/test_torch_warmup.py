"""The port's warm-up command (hiprfish_tpu_torch/cli/warmup.py): the JAX
command's flags on the CPU, and a failed build's exit with the
compiler's output."""

import os
import subprocess
import sys

import torch

from hiprfish_tpu_torch.cli import warmup
from hiprfish_tpu_torch.io import _native_build
from hiprfish_tpu_torch.kernels import _build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_warmup_runs_every_family_on_the_cpu(tmp_path):
    # every flag of hiprfish_tpu/cli/warmup.py, plus --device
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "hiprfish_tpu_torch.cli.warmup", "--family",
         "ecoli", "multispecies", "3d", "--size", "64", "48", "--shape3d",
         "2020", "2020", "170", "--max_cells", "256", "--device", "cpu"],
        env=env, cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    err = proc.stderr
    for step in ("ecoli fused engine 64^2 x256", "ecoli fused engine 48^2",
                 "multispecies LP-CV path 64^2",
                 "multispecies LP-CV path 48^2",
                 "3D pipeline (2020, 2020, 170)", "warmup complete in"):
        assert f"# {step}" in err, err
    # nothing is built for the CPU
    assert "kernel library" not in err and "libjxr.so" not in err


def _on_a_card(monkeypatch):
    """main() as if a card were there, the host libraries' builds
    stubbed."""
    monkeypatch.setattr(warmup, "resolve_device",
                        lambda name: torch.device("cuda"))
    monkeypatch.setattr(_native_build, "build", lambda name: name)
    monkeypatch.setattr(_native_build, "missing_headers", lambda name: [])


def test_warmup_failed_build_exits_nonzero_with_compiler_output(
        monkeypatch, capsys):
    _on_a_card(monkeypatch)

    def nvcc_fails(csrc=None):
        raise RuntimeError("nvcc failed (rc 2): nvcc -c lpcv3d.cu\n"
                           "lpcv3d.cu(12): error: identifier undefined")

    monkeypatch.setattr(_build, "build", nvcc_fails)
    assert warmup.main(["--family", "ecoli", "--size", "64"]) == 1
    err = capsys.readouterr().err
    assert "build failed" in err
    assert "lpcv3d.cu(12): error: identifier undefined" in err


def test_warmup_without_nvcc_exits_nonzero(monkeypatch, capsys):
    # the kernel build itself where no nvcc is found: no quiet fallback
    # to the CPU
    _on_a_card(monkeypatch)

    def no_nvcc():
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin)")

    monkeypatch.setattr(_build, "nvcc_path", no_nvcc)
    monkeypatch.setattr(_build, "BUILD_ROOT", _build.BUILD_ROOT / "absent")
    assert warmup.main(["--family", "3d"]) == 1
    assert "nvcc not found" in capsys.readouterr().err


def test_warmup_skips_the_czi_assembler_without_its_headers(monkeypatch,
                                                           capsys):
    built = []
    monkeypatch.setattr(_build, "build", lambda: "libhiprfish_kernels.so")
    monkeypatch.setattr(_native_build, "build",
                        lambda name: built.append(name) or name)
    monkeypatch.setattr(_native_build, "missing_headers",
                        lambda name: ["zstd.h"])
    seconds = warmup.build_libraries()
    assert built == ["libjxr.so"]
    assert set(seconds) == {"kernel library", "libjxr.so"}
    assert "no zstd.h; .czi planes take the Python parser" in \
        capsys.readouterr().err
