"""Build the readers' host libraries from ``native/*.cc`` with g++ and hand
them to ctypes.

Two libraries, with the flags of ``native/Makefile``:

    g++ -O3 -std=c++17 -shared -fPIC -pthread jxr.cc -o libjxr.so
    g++ -O3 -std=c++17 -shared -fPIC -pthread czi_native.cc jxr.cc \
        -o libczi_native.so -lzstd -ljpeg

each source compiled to an object first with the same flags, then
linked. ``libjxr.so`` (the JPEG-XR codec) needs nothing but the C++
runtime; ``libczi_native.so`` (the threaded plane assembler, with the
codec linked in) needs the zstd and libjpeg headers and libraries, and
compiles its own source first, so a missing header fails in a fraction
of a second. Both land in
``build/torch_native/<hash>/`` at the repository root, where ``<hash>``
covers the sources and the flags; the JAX package's ``native/build/`` is
never read or written. A build happens at a library's first use, never
at import; it compiles to a temporary name and renames it into place, so
threads and processes that race to build the same library are safe. A
failed build raises ``NativeBuildError`` with the compiler's output.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import threading
from pathlib import Path

_ROOT = Path(__file__).resolve().parent.parent.parent
NATIVE = _ROOT / "native"
BUILD_ROOT = _ROOT / "build" / "torch_native"
CXX = "g++"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
# library -> (sources under native/, link flags)
LIBRARIES = {
    "libjxr.so": (("jxr.cc",), ()),
    "libczi_native.so": (("czi_native.cc", "jxr.cc"), ("-lzstd", "-ljpeg")),
}

# library -> the system headers its sources include
HEADERS = {"libczi_native.so": ("zstd.h", "jpeglib.h")}

_lock = threading.Lock()


class NativeBuildError(RuntimeError):
    """A reader library failed to compile or link."""


def build_dir() -> Path:
    h = hashlib.sha256()
    for name in sorted({s for srcs, _ in LIBRARIES.values() for s in srcs}):
        h.update(name.encode())
        h.update((NATIVE / name).read_bytes())
    h.update(" ".join((CXX, *CXX_FLAGS)).encode())
    for lib, (srcs, link) in sorted(LIBRARIES.items()):
        h.update(" ".join((lib, *srcs, *link)).encode())
    return BUILD_ROOT / h.hexdigest()[:16]


def _run(cmd: list) -> None:
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise NativeBuildError(f"{' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        raise NativeBuildError(
            f"g++ failed (rc {proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}")


def _object(src: str, out_dir: Path) -> Path:
    """native/<src> compiled to an object in ``out_dir`` (once)."""
    obj = out_dir / (Path(src).stem + ".o")
    if not obj.exists():
        tmp = out_dir / f"{obj.name}.{os.getpid()}.tmp"
        _run([CXX, *CXX_FLAGS, "-c", str(NATIVE / src), "-o", str(tmp)])
        os.replace(tmp, obj)
    return obj


def build(name: str) -> Path:
    """The path of library ``name`` (a key of LIBRARIES), compiled first if
    it is not built yet. Raises NativeBuildError when g++ fails."""
    srcs, link = LIBRARIES[name]
    out_dir = build_dir()
    lib = out_dir / name
    with _lock:
        if lib.exists():
            return lib
        out_dir.mkdir(parents=True, exist_ok=True)
        objs = [str(_object(src, out_dir)) for src in srcs]
        tmp = out_dir / f"{name}.{os.getpid()}.tmp"
        _run([CXX, *CXX_FLAGS, *objs, "-o", str(tmp), *link])
        os.replace(tmp, lib)
    return lib


def missing_headers(name: str) -> list:
    """The system headers of library ``name`` that the preprocessor does
    not find (HEADERS); raises NativeBuildError when g++ cannot run."""
    missing = []
    for header in HEADERS.get(name, ()):
        try:
            proc = subprocess.run([CXX, "-x", "c++", "-E", "-"],
                                  input=f"#include <{header}>\n",
                                  capture_output=True, text=True,
                                  timeout=60)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise NativeBuildError(f"{CXX} -E: {e}") from e
        if proc.returncode != 0:
            missing.append(header)
    return missing
