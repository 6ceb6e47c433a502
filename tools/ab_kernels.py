"""Time two builds of kernels B1-B6 in turns on one GPU.

    git archive <commit> hiprfish_tpu_torch/csrc | tar -x -C build/ab_old
    python tools/ab_kernels.py --old build/ab_old/hiprfish_tpu_torch/csrc \\
        [--only NAME ...] [--out PATH]

Builds the package's ``csrc/`` and the older copy named by ``--old`` (each
into its own hashed directory under build/torch_kernels/, the two builds
in parallel) and prints ptxas's registers and spills of ``nlm.cu``,
``lpcv2d.cu``, ``segstats.cu`` and ``lpcv3d.cu`` for both. Then, at the main
paths' shapes:

  * B1 on chip_smoke.py's 2000^2 smooth image (h 0.02, patch 7, pd 11),
    and B2 (patch 11, phi 9) on its output, as phase 3 runs them;
  * B3 at chip_smoke.py's column sets: counts only, counts + the 41-class
    erosion-depth histogram, the bf16 63-channel cube (the 2000^2 7-bit
    FOV's labels, 16384 segments), the 10-bit 144-column set (the 10-bit
    FOV: 95 bf16 channels, moments, a random 41-class aux image and 0/1
    mask) and counts on a 3D tile's 488 x 170 x 2020 labels (8192
    segments);
  * B4 on the 2000^2 labels (16384-entry table) and on the 3D tile;
  * B5 on chip_smoke.py phase 6's bf16 (63, 2, 2020, 2020) channels-major
    slab (z 78-79 of the 3D fixture, 16384 segments);
  * B6 in bf16 mode on the 256 x 170 x 256 (X, Z, Y) sub-volume and on the
    whole normalised 2020 x 170 x 2020 volume of chip_smoke.py phase 6;

it holds the two builds' outputs together and times each kernel in turns,
old, new, new, old, each turn by chip_smoke._time_ms (the device time per
call, behind a spin kernel that keeps the host's launch overhead off the
device's timeline). B3's turns include zeroing its table, as its wrapper
does, and so do B5's. B1 must agree within 1e-5, B2 and B6 within 1e-6
absolute (the kernels' tolerances against their plain twins), B4 exactly,
B5's counts exactly and its sums within 2^-16 relative; B3's count,
border, aux and mask columns exactly, its channel sums within 2^-16
relative, and its moments within 2 (n - 1) 2^-24 relative when either
build adds them as f32 in atomic order (bitwise when both sum them in
int64). An older ``hf_label_stats`` without the moments' int64 scratch
argument, or an ``hf_lpcv2d_f32`` with its stencil compiled in, is called
with its own signature, and so is an ``hf_lpcv2d_f32`` from before its
global scratch argument. It prints one JSON object with the card's name and
power limit and every turn's time, and writes it to
``--out`` (default build/ab_kernels.json). Needs a CUDA device; imports
neither jax nor the JAX package.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# hf_label_stats of a build that adds the moments as f32 (no int64 scratch
# argument; a `moments` flag instead): labels, image, image_is_bf16, aux,
# mask, acc, n, h, w, nchan, num_segments, aux_classes, moments, has_mask,
# ncols, stream
LABEL_STATS_F32_MOMENTS = (_P, _P, _I, _P, _P, _P, _L, _I, _I, _I, _I, _I,
                           _I, _I, _I, _P)


# hf_lpcv2d_f32 of a build whose stencil is compiled in (11, 9): img, out,
# h, w, patch, phi, stream
LPCV2D_FIXED = (_P, _P, _I, _I, _I, _I, _P)
# ... and of a build that takes the table but no scratch: img, out, h, w,
# patch, phi, table (host), table (device, may be null), stream
LPCV2D_NO_SCRATCH = (_P, _P, _I, _I, _I, _I, _P, _P, _P)


def _scratch_lpcv2d(csrc: Path) -> bool:
    """Does this copy of csrc/ take B2's global scratch argument?"""
    return "hf_lpcv2d_scratch_bytes" in (csrc / "lpcv2d.cu").read_text()


def _table_lpcv2d(csrc: Path) -> bool:
    """Does this copy of csrc/ take B2's line table at launch?"""
    return "table_host" in (csrc / "lpcv2d.cu").read_text()


def _int64_moments(csrc: Path) -> bool:
    """Does this copy of csrc/ sum B3's moments in an int64 scratch?"""
    return "unsigned long long* mom" in (csrc / "segstats.cu").read_text()


def _open(_build, path: Path, csrc: Path):
    """The library at ``path`` with the signatures of the sources it was
    built from."""
    sigs = dict(_build.SIGNATURES)
    if not _int64_moments(csrc):
        sigs["hf_label_stats"] = LABEL_STATS_F32_MOMENTS
    if not _table_lpcv2d(csrc):
        sigs["hf_lpcv2d_f32"] = LPCV2D_FIXED
    elif not _scratch_lpcv2d(csrc):
        sigs["hf_lpcv2d_f32"] = LPCV2D_NO_SCRATCH
    lib = ctypes.CDLL(str(path))
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.hf_error_string.argtypes = [ctypes.c_int]
    lib.hf_error_string.restype = ctypes.c_char_p
    lib.int64_moments = _int64_moments(csrc)
    lib.table_lpcv2d = _table_lpcv2d(csrc)
    lib.scratch_lpcv2d = _scratch_lpcv2d(csrc)
    return lib


def _build_both(_build, old: Path):
    """(new library path, old library path), built in parallel."""
    paths, errors = {}, []

    def run(key, csrc):
        try:
            paths[key] = _build.build(csrc)
        except Exception as e:  # reported below, after both finish
            errors.append(e)

    threads = [threading.Thread(target=run, args=(k, c))
               for k, c in (("new", _build.CSRC), ("old", old))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return paths["new"], paths["old"]


def _b3_agree(torch, a, b, nmom: int, nchan: int, exact_moments: bool):
    """(max abs error, ok) of two builds' B3 tables: count, border, aux and
    mask columns equal; channel sums within 2^-16 relative; moments equal
    when both builds sum them in int64, else within 2 (n - 1) 2^-24
    relative (any two f32 orders of n non-negative terms)."""
    ncols = a.shape[1]
    sums = list(range(2 + nmom, 2 + nmom + nchan))
    moms = list(range(2, 2 + nmom))
    exact = [c for c in range(ncols) if c not in sums and c not in moms]
    err = float((a - b).abs().max())
    ok = bool(torch.equal(a[:, exact], b[:, exact]))
    if nchan:
        rel = (a[:, sums] - b[:, sums]).abs() / b[:, sums].abs().clamp(min=1)
        ok = ok and float(rel.max()) <= 2.0 ** -16
    if nmom:
        if exact_moments:
            ok = ok and bool(torch.equal(a[:, moms], b[:, moms]))
        else:
            n = float(b[:, 0].max())
            rel = (a[:, moms] - b[:, moms]).abs() \
                / b[:, moms].abs().clamp(min=1)
            ok = ok and float(rel.max()) <= 2.0 * max(n - 1, 1) * 2.0 ** -24
    return err, ok


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", required=True, type=Path,
                    help="directory with the older nlm.cu, segstats.cu, "
                         "lpcv3d.cu and the rest of that csrc/")
    ap.add_argument("--out", type=Path, default=ROOT / "build" /
                    "ab_kernels.json")
    ap.add_argument("--only", nargs="+", default=None,
                    help="time only the cases whose names start with one "
                         "of these (e.g. lpcv2d stats_cm)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("ab_kernels: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    import chip_smoke
    from hiprfish_tpu_torch.config import SEVEN_BIT
    from hiprfish_tpu_torch.kernels import _build
    from hiprfish_tpu_torch.ops import line_profile
    from hiprfish_tpu_torch.utils import synthetic, synthetic3d as s3

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    old_dir = args.old.resolve()
    new_path, old_path = _build_both(_build, old_dir)
    libs = {"new": _open(_build, new_path, _build.CSRC),
            "old": _open(_build, old_path, old_dir)}
    ptxas = {}
    for key, csrc in (("new", _build.CSRC), ("old", old_dir)):
        for stem in ("nlm", "lpcv2d", "segstats", "lpcv3d"):
            ptxas[f"{key} {stem}"] = _build.ptxas_report(stem, csrc)
            for line in ptxas[f"{key} {stem}"]:
                print(f"ptxas {key} {stem}.cu: {line}")

    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def nlm(lib, img, out):
        h2 = float(np.float32(0.02 * 0.02))
        _build.check(lib, lib.hf_nlm_f32(img.data_ptr(), out.data_ptr(),
                                         *img.shape, 11, 7, h2, stream),
                     "nlm")
        return out

    table2d = np.ascontiguousarray(line_profile.line_table_2d(11, 9),
                                   dtype=np.int32)

    table2d_dev = torch.from_numpy(table2d).to(dev)

    def lpcv2d(lib, img, out):
        extra = ()
        if lib.scratch_lpcv2d:
            extra = (table2d.ctypes.data, table2d_dev.data_ptr(), None)
        elif lib.table_lpcv2d:
            extra = (table2d.ctypes.data, None)
        _build.check(lib, lib.hf_lpcv2d_f32(img.data_ptr(), out.data_ptr(),
                                            *img.shape, 11, 9, *extra,
                                            stream), "lpcv2d")
        return out

    def lpcv3d(lib, vol, out):
        _build.check(lib, lib.hf_lpcv3d(vol.data_ptr(), out.data_ptr(),
                                        *vol.shape, 11, 9, 9, 1, stream),
                     "lpcv3d")
        return out

    def label_stats(lib, a):
        """B3 through ``lib`` as its wrapper calls it: a zeroed table (and
        int64 moments scratch), one launch."""
        labels, image, aux, mask, nseg, naux, moments, h, w = a
        nchan = 0 if image is None else image.shape[1]
        ncols = 2 + 5 * moments + nchan + naux + (mask is not None)
        acc = torch.zeros((nseg, ncols), dtype=torch.float32, device=dev)
        ptr = [labels.data_ptr(),
               None if image is None else image.data_ptr(),
               int(image is not None and image.dtype == torch.bfloat16),
               None if aux is None else aux.data_ptr(),
               None if mask is None else mask.data_ptr(), acc.data_ptr()]
        if lib.int64_moments:
            mom = torch.zeros((nseg, 5), dtype=torch.int64, device=dev) \
                if moments else None
            err = lib.hf_label_stats(
                *ptr, None if mom is None else mom.data_ptr(),
                labels.numel(), h, w, nchan, nseg, naux,
                int(mask is not None), ncols, stream)
        else:
            err = lib.hf_label_stats(*ptr, labels.numel(), h, w, nchan, nseg,
                                     naux, int(moments), int(mask is not None),
                                     ncols, stream)
        _build.check(lib, err, "label_stats")
        return acc

    def stats_cm(lib, a):
        """B5 through ``lib`` as its wrapper calls it: a zeroed table, one
        launch."""
        labels, image, nseg = a
        acc = torch.zeros((nseg, 1 + image.shape[0]), dtype=torch.float32,
                          device=dev)
        _build.check(lib, lib.hf_stats_cm(
            labels.data_ptr(), image.data_ptr(),
            int(image.dtype == torch.bfloat16), acc.data_ptr(),
            labels.numel(), image.shape[0], nseg, stream), "stats_cm")
        return acc

    def b5_agree(a, b):
        rel = (a[:, 1:] - b[:, 1:]).abs() / b[:, 1:].abs().clamp(min=1)
        return (float((a - b).abs().max()),
                bool(torch.equal(a[:, 0], b[:, 0]))
                and float(rel.max()) <= 2.0 ** -16)

    def label_lookup(lib, a):
        labels, table = a
        out = torch.empty(labels.shape, dtype=torch.float32, device=dev)
        _build.check(lib, lib.hf_label_lookup(
            labels.data_ptr(), table.data_ptr(), out.data_ptr(),
            labels.numel(), table.shape[0], stream), "label_lookup")
        return out

    result = {"device": smi, "ptxas": ptxas, "cases": {}}

    def ab(name, fn, x, agree, reps, make_out=False):
        """Both builds' outputs held together, then the four turns."""
        if args.only and not any(name.startswith(o) for o in args.only):
            return None
        outs = {}
        for k, lib in libs.items():
            outs[k] = fn(lib, x, torch.empty_like(x)) if make_out \
                else fn(lib, x)
        torch.cuda.synchronize()
        err, ok = agree(outs["new"], outs["old"])
        turns = []
        for k in ("old", "new", "new", "old"):
            if make_out:
                ms = chip_smoke._time_ms(
                    torch, lambda: fn(libs[k], x, outs[k]), reps)
            else:
                ms = chip_smoke._time_ms(torch, lambda: fn(libs[k], x), reps)
            turns.append([k, ms])
        old_ms = [ms for k, ms in turns if k == "old"]
        new_ms = [ms for k, ms in turns if k == "new"]
        print(f"{name}: new vs old max_abs_err {err:.3e} "
              f"({'ok' if ok else 'FAIL'}); turns (ms) "
              + ", ".join(f"{k} {ms:.4f}" for k, ms in turns)
              + f"; speed-up {np.mean(old_ms) / np.mean(new_ms):.2f}x")
        result["cases"][name] = {"max_abs_err": err, "turns": turns}
        if not ok:
            raise AssertionError(f"{name}: the two builds disagree")
        return outs["new"]

    def within(tol):
        return lambda a, b: (float((a - b).abs().max()),
                             float((a - b).abs().max()) <= tol)

    exact_moments = libs["new"].int64_moments and libs["old"].int64_moments

    def b3(name, a, reps):
        nmom = 5 if a[6] else 0
        nchan = 0 if a[1] is None else a[1].shape[1]
        ab(name, label_stats, a, lambda x, y: _b3_agree(
            torch, x, y, nmom, nchan, exact_moments), reps)

    # 2D: B1, then B3 at each column set and B4 on the 7-bit FOV's labels
    size = synthetic.FLAGSHIP_SHAPE[0]
    img = torch.from_numpy(chip_smoke._smooth_image((size, size), 0)).to(dev)
    den = ab("nlm 2000^2", nlm, img, within(1e-5), 10, make_out=True)
    if den is None:  # B1 not timed: B2 still takes its output
        den = nlm(libs["new"], img, torch.empty_like(img))
    ab("lpcv2d 2000^2", lpcv2d, den, within(1e-6), 10, make_out=True)
    del img, den
    fov = synthetic.flagship_fov()
    labels = torch.from_numpy(fov["truth_labels"].astype(np.int32)).to(dev)
    flat = labels.reshape(-1)
    cube = torch.cat([torch.from_numpy(a) for a in fov["stack"]], dim=2) \
        .to(dev).to(torch.bfloat16).reshape(flat.shape[0], -1)
    del fov
    nseg = 2 * chip_smoke.MAX_CELLS
    naux = chip_smoke.AUX_CLASSES_10B
    b3("label_stats counts 2000^2",
       (flat, None, None, None, nseg, 0, False, size, size), 20)
    b3("label_stats aux41 2000^2",
       (flat, None, chip_smoke._depth_classes(torch, labels), None, nseg,
        naux, False, size, size), 20)
    b3("label_stats cube7b 2000^2",
       (flat, cube, None, None, nseg, 0, False, size, size), 10)
    gen = torch.Generator(device="cpu").manual_seed(0)
    tbl = torch.rand(nseg, generator=gen).to(dev)
    ab("label_lookup 2000^2", label_lookup, (labels, tbl), within(0.0), 20)
    del labels, flat, cube
    efov = synthetic.ecoli_fov()
    esize = synthetic.ECOLI_SHAPE[0]
    eflat = torch.from_numpy(efov["truth_labels"]).to(dev).reshape(-1)
    ecube = torch.cat([torch.from_numpy(a) for a in efov["stack"]], dim=2) \
        .to(dev).to(torch.bfloat16).reshape(eflat.shape[0], -1)
    del efov
    gen = torch.Generator(device="cpu").manual_seed(9)
    eaux = torch.randint(0, naux, eflat.shape, generator=gen,
                         dtype=torch.int32).to(dev)
    emask = (torch.rand(eflat.shape, generator=gen) > 0.3) \
        .to(torch.float32).to(dev)
    b3("label_stats cols10b 2000^2",
       (eflat, ecube, eaux, emask, nseg, naux, True, esize, esize), 10)
    del eflat, ecube, eaux, emask

    # 3D: B3 and B4 on a tile's labels, B6 on the sub-volume and volume
    spec = s3.VolumeSpec(shape=chip_smoke.SHAPE_3D, spacing=(36, 36, 52),
                         seed=5)
    tile = chip_smoke._tile_labels(torch, spec, 127, dev)
    tflat = tile.reshape(-1)
    tcap = chip_smoke.TILED_3D["tile_cap"]
    b3(f"label_stats tile3d {'x'.join(map(str, tile.shape))}",
       (tflat, None, None, None, tcap, 0, False, tile.shape[0],
        tflat.numel() // tile.shape[0]), 10)
    ttbl = torch.rand(tcap, generator=gen).to(dev)
    ab(f"label_lookup tile3d {'x'.join(map(str, tile.shape))}",
       label_lookup, (tile, ttbl), within(0.0), 10)
    del tile, tflat
    lut = np.stack([synthetic.barcode_spectrum(SEVEN_BIT, c)
                    for c in range(1, 128)]).astype(np.float32)
    lut_dev = torch.from_numpy(lut).to(dev)
    lab_cm = s3.truth_chunk(spec, 127, 78, 2, dev)[0] \
        .permute(2, 0, 1).contiguous().reshape(-1)
    img_cm = s3.channel_chunk_cm(spec, 127, 78, 2, lut_dev, 1,
                                 torch.bfloat16).reshape(63, -1)
    ab("stats_cm bf16 63x2x2020x2020", stats_cm,
       (lab_cm, img_cm, chip_smoke.MAX_CELLS_3D), b5_agree, 10)
    del lab_cm, img_cm
    vol = s3.build_sum_volume(spec, 127, lut.sum(axis=1), seed=1,
                              z_chunk=16, device=dev)
    vol_xzy = (vol / vol.max()).permute(0, 2, 1).contiguous()
    del vol
    sub = vol_xzy[:256, :, :256].contiguous()
    ab("lpcv3d 256x170x256", lpcv3d, sub, within(1e-6), 10, make_out=True)
    ab("lpcv3d 2020x170x2020", lpcv3d, vol_xzy, within(1e-6), 3,
       make_out=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
