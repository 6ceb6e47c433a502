"""Read the reference's pickled classifier artifacts without sklearn,
joblib, umap-learn, pynndescent or numba (the port's counterpart of the
permissive loader in hiprfish_tpu/models/umap_infer.py).

The reference's trainer writes its fitted ``umap.UMAP``, its SVCs and its
``StandardScaler`` with ``joblib.dump``. joblib's format is a pickle in
which every numpy array is replaced by a ``NumpyArrayWrapper`` object whose
raw bytes follow it in the file, outside the pickle's opcodes. The reader
here is the pure-Python ``pickle._Unpickler`` with its own copy of the
``dispatch`` table: after the ``BUILD`` of a wrapper it reads the array from
the file as joblib's ``read_array`` does (an optional padding byte and that
many bytes, ``count x itemsize`` raw bytes straight into one numpy buffer,
Fortran order stored transposed, byte order made native; object arrays as
a nested pickle in the same file). Plain pickles load through the same
reader.

Only numpy's array and dtype reconstruction and the builtins a pickle
needs resolve to real objects. Every other global becomes an inert stub
class, even where its module is importable, so a file loads the same way
whatever is installed: the card machine has none of those packages.
Loading therefore runs no code of the pickle's classes (no ``eval``,
``open`` or import of an arbitrary module).

joblib files compressed with zlib or gzip are inflated with the standard
library; any other compressor, and joblib < 0.10's ``NDArrayWrapper``
(arrays kept in side files), raise a ``ValueError`` that names them.
"""

from __future__ import annotations

import gzip
import io
import pickle
import sys
import zlib

import numpy as np


class _Stub:
    """Inert stand-in for any class the reader does not resolve. Takes
    every pickle reconstruction protocol (REDUCE or NEWOBJ with any
    arguments, BUILD with a dict or a (dict, slots) state) and records the
    original module and name."""

    _stub_target = "?"

    def __init__(self, *args, **kwargs):
        self._stub_args = args
        self._stub_kwargs = kwargs

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        elif isinstance(state, tuple):
            for part in state:
                if isinstance(part, dict):
                    self.__dict__.update(part)
        else:
            self._stub_state = state

    def __repr__(self):
        return f"<stub {self._stub_target}>"


# the builtins a pickle of arrays, estimators and their containers needs
_SAFE_GLOBALS = {
    "builtins": {"object", "list", "dict", "tuple", "set", "frozenset",
                 "bytearray", "bytes", "str", "int", "float", "complex",
                 "bool", "slice", "range", "type", "getattr"},
    "copyreg": {"_reconstructor", "__newobj__", "__newobj_ex__"},
    "collections": {"OrderedDict", "defaultdict", "deque", "Counter"},
    "_codecs": {"encode"},
}
# numpy's reconstruction helpers, under numpy.core (numpy < 2, and the
# reference's files) and numpy._core
_NUMPY_GLOBALS = {
    "numpy": {"ndarray", "dtype"},
    "multiarray": {"_reconstruct", "scalar"},
    "numeric": {"_frombuffer"},
}
# joblib's compressors by the magic bytes joblib itself detects them by
# (joblib/compressor.py), the two the standard library inflates here first
_INFLATE = ((b"\x78", "zlib", zlib.decompress),
            (b"\x1f\x8b", "gzip", gzip.decompress))
_OTHER_COMPRESSORS = ((b"ZF", "joblib < 0.9.3 'ZF' compression"),
                      (b"BZ", "bz2"), (b"\xfd\x37\x7a\x58\x5a", "xz"),
                      (b"\x5d\x00", "lzma"), (b"\x04\x22\x4d\x18", "lz4"))


def _numpy_global(module: str, name: str):
    parts = module.split(".")
    if parts[0] != "numpy":
        return None
    if module == "numpy":
        return getattr(np, name) if name in _NUMPY_GLOBALS["numpy"] else None
    if (len(parts) == 3 and parts[1] in ("core", "_core")
            and name in _NUMPY_GLOBALS.get(parts[2], ())):
        core = np._core if hasattr(np, "_core") else np.core
        return getattr(getattr(core, parts[2]), name)
    return None


def _native(array: np.ndarray) -> np.ndarray:
    """The array in the host's byte order (joblib's
    _ensure_native_byte_order)."""
    foreign = ">" if sys.byteorder == "little" else "<"
    if array.dtype.byteorder == foreign:
        return array.byteswap().view(array.dtype.newbyteorder("="))
    return array


class _LegacyUnpickler(pickle._Unpickler):
    """The pure-Python unpickler with stub globals and joblib's array
    framing."""

    dispatch = dict(pickle._Unpickler.dispatch)

    def __init__(self, file):
        super().__init__(file)
        self._file = file
        self._stubs = {}

    def find_class(self, module, name):
        if self.proto < 3 and self.fix_imports:
            import _compat_pickle

            if (module, name) in _compat_pickle.NAME_MAPPING:
                module, name = _compat_pickle.NAME_MAPPING[(module, name)]
            elif module in _compat_pickle.IMPORT_MAPPING:
                module = _compat_pickle.IMPORT_MAPPING[module]
        real = _numpy_global(module, name)
        if real is not None:
            return real
        if name in _SAFE_GLOBALS.get(module, ()):
            return getattr(sys.modules.get(module) or __import__(module),
                           name)
        key = (module, name)
        if key not in self._stubs:
            self._stubs[key] = type(name, (_Stub,),
                                    {"_stub_target": f"{module}.{name}"})
        return self._stubs[key]

    def _readinto(self, buf: memoryview) -> None:
        """Fill ``buf`` from the pickle's current frame, then the file."""
        n = 0
        frame = self._unframer.current_frame
        if frame is not None:
            n = frame.readinto(buf)
            if n < len(buf):
                self._unframer.current_frame = None
        while n < len(buf):
            got = self._file.readinto(buf[n:])
            if not got:
                raise pickle.UnpicklingError("the file ends inside an array")
            n += got

    def _read_array(self, wrapper) -> np.ndarray:
        """joblib's NumpyArrayWrapper.read_array, for the wrapper just
        built."""
        state = vars(wrapper)
        shape = tuple(int(s) for s in state["shape"])
        dtype = np.dtype(state["dtype"])
        if dtype.hasobject:
            frame = self._unframer.current_frame
            if frame is not None and frame.read():
                raise pickle.UnpicklingError(
                    "an object array's pickle inside a frame")
            self._unframer.current_frame = None
            return _LegacyUnpickler(self._file).load()
        if state.get("numpy_array_alignment_bytes") is not None:
            pad = bytearray(1)
            self._readinto(memoryview(pad))
            if pad[0]:
                self._readinto(memoryview(bytearray(pad[0])))
        array = np.empty(int(np.prod(shape, dtype=np.int64)), dtype)
        if array.size:
            self._readinto(memoryview(array.view(np.uint8)))
        if state.get("order", "C") == "F":
            array = array.reshape(shape[::-1]).transpose()
        else:
            array = array.reshape(shape)
        return _native(array)

    def load_build(self):
        pickle._Unpickler.load_build(self)
        inst = self.stack[-1]
        if not isinstance(inst, _Stub):
            return
        kind = type(inst).__name__
        if kind == "NumpyArrayWrapper":
            self.stack[-1] = self._read_array(inst)
        elif kind in ("NDArrayWrapper", "ZNDArrayWrapper"):
            raise ValueError(
                f"{inst._stub_target}: this joblib file keeps its arrays in "
                "side files (joblib < 0.10), which this reader does not "
                "follow; load and dump it again with a newer joblib")

    dispatch[pickle.BUILD[0]] = load_build


def permissive_load(path: str):
    """Load a pickle or a joblib file (plain, zlib or gzip) with stub
    globals and joblib's array framing."""
    with open(path, "rb") as f:
        head = f.read(8)
        if not head:
            raise ValueError(f"{path}: an empty file, not a pickle")
        f.seek(0)
        for magic, name in _OTHER_COMPRESSORS:
            if head.startswith(magic):
                raise ValueError(
                    f"{path}: compressed with {name}, which this reader "
                    "does not inflate (zlib and gzip only)")
        for magic, _, inflate in _INFLATE:
            if head.startswith(magic):
                return _LegacyUnpickler(io.BytesIO(inflate(f.read()))).load()
        return _LegacyUnpickler(f).load()


def get_attr(obj, *names, default=None):
    """The first of ``names`` that ``obj`` has, as an attribute or a dict
    key, else ``default``."""
    for n in names:
        if hasattr(obj, n):
            return getattr(obj, n)
        if isinstance(obj, dict) and n in obj:
            return obj[n]
    return default
