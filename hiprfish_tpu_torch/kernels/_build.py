"""Build the CUDA kernels under ``csrc/`` with nvcc and load them with ctypes.

All ``csrc/*.cu`` files compile into ONE shared library with a plain C
interface (no PyTorch headers, so a build takes seconds, not minutes). Each
source compiles to an object in its own nvcc process, all started together,
and one more nvcc links them:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -c -o X.o csrc/X.cu        # one per source
    nvcc ... -shared -o libhiprfish_kernels.so *.o

The library lands in ``build/torch_kernels/<hash>/`` at the repository
root, where ``<hash>`` covers the sources and the flags, so an edited
source rebuilds and an unchanged one is reused. Kernel B6 is compiled for
one (patch, theta, phi) configuration, from a generated header of tables:
the library holds the default (11, 9, 9); ``load_lpcv3d`` writes any other
configuration's header into a directory of its own under ``<hash>/`` and
compiles ``lpcv3d.cu`` once more against it into a library of its own
(one nvcc call, seconds), at that configuration's first use. ptxas reports each
kernel's registers, shared memory and spills (``-Xptxas -v``); the report
of ``X.cu`` is kept beside the library as ``X.ptxas.txt``. The build
happens at the first kernel launch, never at import. A missing nvcc or a
failed build raises with the compiler's output: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "torch_kernels"
LIB_NAME = "libhiprfish_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# C entry points: name -> argtypes. Every entry returns cudaError_t (int).
SIGNATURES = {
    # img, out, h, w, pd, patch, h2, stream
    "hf_nlm_f32": (_P, _P, _I, _I, _I, _I, _F, _P),
    # img, out, h, w, patch, phi, line table (host), line table (device),
    # scratch, stream
    "hf_lpcv2d_f32": (_P, _P, _I, _I, _I, _I, _P, _P, _P, _P),
    # labels, image, image_is_bf16, aux, mask, acc, moments scratch, n, h,
    # w, nchan, num_segments, aux_classes, has_mask, ncols, stream
    "hf_label_stats": (_P, _P, _I, _P, _P, _P, _P, _L, _I, _I, _I, _I, _I,
                       _I, _I, _P),
    # labels, table, out, n, num_segments, stream
    "hf_label_lookup": (_P, _P, _P, _L, _I, _P),
    # labels, image, image_is_bf16, acc, n, nchan, num_segments, stream
    "hf_stats_cm": (_P, _P, _I, _P, _L, _I, _I, _P),
    # vol, out, nx, nz, ny, patch, theta, phi, bf16, stream
    "hf_lpcv3d": (_P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
}

_lock = threading.Lock()
_lib = None


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME, /usr/local/cuda or $PATH; raises if absent."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "$PATH): the hiprfish_tpu_torch CUDA kernels cannot be built")


def sources(csrc: Path = CSRC) -> list[Path]:
    return sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh"))


def build_dir(csrc: Path = CSRC) -> Path:
    h = hashlib.sha256()
    for p in sources(csrc):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / h.hexdigest()[:16]


def build(csrc: Path = CSRC) -> Path:
    """Compile ``csrc``/*.cu (the package's sources unless another copy is
    named) into the hashed build directory, if not built yet."""
    out_dir = build_dir(csrc)
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    nvcc = nvcc_path()
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    objs, procs = [], []
    for src in sorted(csrc.glob("*.cu")):
        obj = out_dir / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        objs.append(str(obj))
        procs.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    done = [(cmd, proc.communicate(), proc.returncode)
            for cmd, proc in procs]
    for src, (_, (_, err), _) in zip(sorted(csrc.glob("*.cu")), done):
        (out_dir / f"{src.stem}.ptxas.txt").write_text(err)
    tmp = out_dir / f"{LIB_NAME}.{tag}"
    link = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *objs]
    if all(rc == 0 for _, _, rc in done):
        proc = subprocess.run(link, capture_output=True, text=True)
        done.append((link, (proc.stdout, proc.stderr), proc.returncode))
    for cmd, (out, err), rc in done:
        if rc != 0:
            raise RuntimeError(f"nvcc failed (rc {rc}): {' '.join(cmd)}\n"
                               f"{out}\n{err}")
    os.replace(tmp, lib)
    for obj in objs:
        os.remove(obj)
    return lib


def open_library(path: Path) -> ctypes.CDLL:
    """Load a built kernel library and declare its C entry points."""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    # h, w, patch, phi -> bytes of B2's global scratch
    lib.hf_lpcv2d_scratch_bytes.argtypes = [_I, _I, _I, _I]
    lib.hf_lpcv2d_scratch_bytes.restype = _L
    lib.hf_error_string.argtypes = [ctypes.c_int]
    lib.hf_error_string.restype = ctypes.c_char_p
    return lib


def load() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = open_library(build())
    return _lib


def lpcv3d_dir(patch: int, theta: int, phi: int,
               csrc: Path = CSRC) -> tuple[Path, str]:
    """(build directory, header text) of kernel B6 at a configuration; the
    directory's name carries a hash of the header."""
    from hiprfish_tpu_torch.kernels import gen_lpcv3d_tables

    text = gen_lpcv3d_tables.header_text(patch, theta, phi)
    tag = hashlib.sha256(text.encode()).hexdigest()[:12]
    return build_dir(csrc) / f"lpcv3d_{patch}_{theta}_{phi}_{tag}", text


def build_lpcv3d(patch: int, theta: int, phi: int,
                 csrc: Path = CSRC) -> Path:
    """Compile ``lpcv3d.cu`` against the generated header of (patch,
    theta, phi) into its own library, if not built yet; raises with the
    compiler's output when nvcc fails."""
    out_dir, text = lpcv3d_dir(patch, theta, phi, csrc)
    lib = out_dir / "liblpcv3d.so"
    if lib.exists():
        return lib
    nvcc = nvcc_path()
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    header = out_dir / f"lpcv3d_tables.{tag}.cuh"
    header.write_text(text)
    tmp = out_dir / f"liblpcv3d.so.{tag}"
    cmd = [nvcc, *NVCC_FLAGS, f'-DHF_LP3D_TABLES="{header}"', "-shared",
           "-o", str(tmp), str(csrc / "lpcv3d.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (out_dir / "lpcv3d.ptxas.txt").write_text(proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed (rc {proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib)
    os.replace(header, out_dir / "lpcv3d_tables.cuh")
    return lib


_lpcv3d_libs: dict = {}


def load_lpcv3d(patch: int, theta: int, phi: int) -> ctypes.CDLL:
    """The loaded B6 library of a configuration other than the default,
    built on first use."""
    key = (patch, theta, phi)
    with _lock:
        if key not in _lpcv3d_libs:
            lib = ctypes.CDLL(str(build_lpcv3d(patch, theta, phi)))
            lib.hf_lpcv3d.argtypes = list(SIGNATURES["hf_lpcv3d"])
            lib.hf_lpcv3d.restype = ctypes.c_int
            _lpcv3d_libs[key] = lib
    return _lpcv3d_libs[key]


def ptxas_report(stem: str, csrc: Path = CSRC) -> list[str]:
    """ptxas's lines on registers, shared memory and spills for the
    kernels of ``csrc/<stem>.cu``, from its last build."""
    path = build_dir(csrc) / f"{stem}.ptxas.txt"
    return [ln.strip() for ln in path.read_text().splitlines()
            if "Used" in ln or "spill" in ln or "Compiling entry" in ln]


def check(lib: ctypes.CDLL, err: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error "
                           f"{err} ({lib.hf_error_string(err).decode()})")
