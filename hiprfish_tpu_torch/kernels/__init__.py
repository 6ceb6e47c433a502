"""ctypes bindings of the hand-written CUDA kernels (sources in ``csrc/``).

Each binding checks device, dtype, shape and contiguity, allocates its
outputs with torch, launches on the current CUDA stream, raises on a
launch error, and adds one to its own ``launches`` count. The library is
built by nvcc at the first launch (kernels/_build.py); nothing is built or
imported from CUDA when this module is imported.

The ops modules call these only for CUDA tensors; a CPU tensor takes the
plain-torch version beside each wrapper, and any other device raises.
"""

from __future__ import annotations

import numpy as np
import torch

from hiprfish_tpu_torch.kernels import _build


def _require(t: torch.Tensor, name: str, dtypes, ndim: int | None = None):
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor")
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if ndim is not None and t.ndim != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def nlm(img: torch.Tensor, h: float, patch_size: int,
        patch_distance: int) -> torch.Tensor:
    """B1: fast-mode NLM of an (H, W) f32 image (csrc/nlm.cu), for any odd
    patch_size and 0 < patch_distance < min(H, W), the TPU kernel's
    domain: up to patch_distance + patch_size // 2 = 72 the block's window
    and weight field sit in shared memory, beyond it the kernel reads the
    window from global memory."""
    _require(img, "nlm img", (torch.float32,), 2)
    hh, ww = img.shape
    if patch_size < 1 or patch_size % 2 != 1 \
            or not 0 < patch_distance < min(hh, ww):
        raise ValueError("nlm: odd patch_size and 0 < patch_distance < "
                         "min(H, W) required")
    out = torch.empty_like(img)
    lib = _build.load()
    # h^2 rounded to f32 the way the reference computes jnp.float32(h * h)
    h2 = float(np.float32(h * h))
    err = lib.hf_nlm_f32(img.data_ptr(), out.data_ptr(), hh, ww,
                         patch_distance, patch_size, h2, _stream(img))
    _build.check(lib, err, "nlm")
    nlm.launches += 1
    return out


# B2's line tables, host (int32) and device copies, by stencil and device
_lpcv2d_tables: dict = {}


def lpcv2d(img: torch.Tensor, patch_size: int = 11,
           phi_range: int = 9) -> torch.Tensor:
    """B2: LP-CV enhancement of an (H, W) f32 image (csrc/lpcv2d.cu) along
    line_table_2d(patch_size, phi_range), for any odd patch_size and any
    phi_range >= 1. The table is built here (the (11, 9) kernel relies on
    every line holding the centre as its middle sample) and copied to the
    device once; (11, 9) also takes its offsets in the launch parameters,
    and every other stencil a global scratch for its ratios, allocated
    here."""
    from hiprfish_tpu_torch.ops.line_profile import _line_table_2d_cached

    _require(img, "lpcv2d img", (torch.float32,), 2)
    patch, phi = patch_size, phi_range
    if patch < 1 or patch % 2 != 1 or phi < 1:
        raise ValueError("lpcv2d: odd patch_size and phi_range >= 1 "
                         "required")
    key = (patch, phi, img.device)
    if key not in _lpcv2d_tables:
        tab = np.ascontiguousarray(_line_table_2d_cached(patch, phi),
                                   dtype=np.int32)
        _lpcv2d_tables[key] = (tab, torch.from_numpy(tab).to(img.device))
    tab, tab_dev = _lpcv2d_tables[key]
    out = torch.empty_like(img)
    lib = _build.load()
    hh, ww = img.shape
    nbytes = lib.hf_lpcv2d_scratch_bytes(hh, ww, patch, phi)
    scratch = torch.empty(nbytes // 4, dtype=torch.float32,
                          device=img.device) if nbytes > 0 else None
    err = lib.hf_lpcv2d_f32(img.data_ptr(), out.data_ptr(), hh, ww, patch,
                            phi, tab.ctypes.data, tab_dev.data_ptr(),
                            None if scratch is None else scratch.data_ptr(),
                            _stream(img))
    _build.check(lib, err, "lpcv2d")
    lpcv2d.launches += 1
    return out


def label_stats(labels: torch.Tensor, image: torch.Tensor | None,
                aux: torch.Tensor | None, mask: torch.Tensor | None,
                num_segments: int, aux_classes: int, moments: bool,
                h: int, w: int) -> torch.Tensor:
    """B3: (num_segments, ncols) f32 stats table (csrc/segstats.cu).

    ``labels`` (N,) int32; ``image`` (N, C) f32 or bf16; ``aux`` (N,)
    int32; ``mask`` (N,) f32. Column order as segstats.LabelStats packs it.
    The moments are summed exactly in a zeroed (num_segments, 5) int64
    scratch allocated here, then rounded once to f32.
    """
    _require(labels, "label_stats labels", (torch.int32,), 1)
    n = labels.shape[0]
    if n != h * w:
        raise ValueError("label_stats: labels size != h * w")
    nchan = 0
    if image is not None:
        _require(image, "label_stats image", (torch.float32, torch.bfloat16),
                 2)
        if image.shape[0] != n:
            raise ValueError("label_stats: image rows != labels size")
        nchan = image.shape[1]
    if aux is not None:
        _require(aux, "label_stats aux", (torch.int32,), 1)
        if aux.shape[0] != n or aux_classes <= 0:
            raise ValueError("label_stats: bad aux")
    if mask is not None:
        _require(mask, "label_stats mask", (torch.float32,), 1)
        if mask.shape[0] != n:
            raise ValueError("label_stats: mask size != labels size")
    naux = aux_classes if aux is not None else 0
    ncols = 2 + (5 if moments else 0) + nchan + naux \
        + (1 if mask is not None else 0)
    acc = torch.zeros((num_segments, ncols), dtype=torch.float32,
                      device=labels.device)
    mom = torch.zeros((num_segments, 5), dtype=torch.int64,
                      device=labels.device) if moments else None
    lib = _build.load()
    err = lib.hf_label_stats(
        labels.data_ptr(), image.data_ptr() if image is not None else None,
        int(image is not None and image.dtype == torch.bfloat16),
        aux.data_ptr() if aux is not None else None,
        mask.data_ptr() if mask is not None else None,
        acc.data_ptr(), mom.data_ptr() if mom is not None else None, n, h, w,
        nchan, num_segments, naux, int(mask is not None), ncols,
        _stream(labels))
    _build.check(lib, err, "label_stats")
    label_stats.launches += 1
    return acc


def label_lookup(labels: torch.Tensor, table: torch.Tensor,
                 out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """B4: per-pixel table[label], 0 for label <= 0 (csrc/segstats.cu).
    ``labels`` int32 any shape, ``table`` (S,) f32. ``out_dtype``
    float32 stores the table value; int32 stores it converted toward zero
    (hf_label_lookup_i32), bitwise the float32 output's .to(torch.int32)."""
    _require(labels, "label_lookup labels", (torch.int32,))
    _require(table, "label_lookup table", (torch.float32,), 1)
    if out_dtype == torch.float32:
        name = "hf_label_lookup"
    elif out_dtype == torch.int32:
        name = "hf_label_lookup_i32"
    else:
        raise TypeError(f"label_lookup: out_dtype {out_dtype} is neither "
                        "float32 nor int32")
    out = torch.empty(labels.shape, dtype=out_dtype, device=labels.device)
    lib = _build.load()
    err = getattr(lib, name)(labels.data_ptr(), table.data_ptr(),
                             out.data_ptr(), labels.numel(), table.shape[0],
                             _stream(labels))
    _build.check(lib, err, "label_lookup")
    label_lookup.launches += 1
    label_lookup.launches_i32 += out_dtype == torch.int32
    return out


def stats_cm(labels: torch.Tensor, image: torch.Tensor, num_segments: int,
             out: torch.Tensor | None = None) -> torch.Tensor:
    """B5: (num_segments, 1 + C) f32 [count, channel sums] table of a
    channels-major image (csrc/segstats.cu). ``labels`` (n,) int32,
    ``image`` (C, n) f32 or bf16. With ``out`` (a contiguous
    (num_segments, 1 + C) f32 table on the same device) the kernel adds
    into it and returns it; else into a zeroed table of its own."""
    _require(labels, "stats_cm labels", (torch.int32,), 1)
    _require(image, "stats_cm image", (torch.float32, torch.bfloat16), 2)
    if image.shape[1] != labels.shape[0]:
        raise ValueError("stats_cm: image columns != labels size")
    shape = (num_segments, 1 + image.shape[0])
    if out is None:
        out = torch.zeros(shape, dtype=torch.float32, device=labels.device)
    else:
        _require(out, "stats_cm out", (torch.float32,), 2)
        if tuple(out.shape) != shape or out.device != labels.device:
            raise ValueError(f"stats_cm: out must be {shape} on "
                             f"{labels.device}")
    lib = _build.load()
    err = lib.hf_stats_cm(labels.data_ptr(), image.data_ptr(),
                          int(image.dtype == torch.bfloat16), out.data_ptr(),
                          labels.shape[0], image.shape[0], num_segments,
                          _stream(labels))
    _build.check(lib, err, "stats_cm")
    stats_cm.launches += 1
    return out


def lpcv3d(vol: torch.Tensor, bf16: bool, patch_size: int = 11,
           theta_range: int = 9, phi_range: int = 9) -> torch.Tensor:
    """B6: 3D LP-CV of an (X, Z, Y) f32 volume (csrc/lpcv3d.cu); ``bf16``
    rounds the samples to bf16 first. The library holds the default
    configuration (11, 9, 9); any other (odd patch_size >= 3,
    theta_range >= 2, phi_range >= 1) is compiled at its first use
    (_build.load_lpcv3d)."""
    _require(vol, "lpcv3d vol", (torch.float32,), 3)
    if patch_size < 3 or patch_size % 2 != 1 or theta_range < 2 \
            or phi_range < 1:
        raise ValueError("lpcv3d: odd patch_size >= 3, theta_range >= 2 "
                         "and phi_range >= 1 required")
    out = torch.empty_like(vol)
    lib = _build.load()
    cfg = (patch_size, theta_range, phi_range)
    klib = lib if cfg == (11, 9, 9) else _build.load_lpcv3d(*cfg)
    err = klib.hf_lpcv3d(vol.data_ptr(), out.data_ptr(), *vol.shape, *cfg,
                         int(bf16), _stream(vol))
    _build.check(lib, err, "lpcv3d")
    lpcv3d.launches += 1
    return out


# the longest run window one hf_flood_runs pass takes, by element size
# (csrc/flood.cu stages a block of W + 1 voxels and one block each side);
# a longer window takes several passes whose radii sum to it
FLOOD_RADIUS = {4: 63, 1: 255}


def run_window(n: int, max_run: int | None) -> int:
    """The radius W of labeling's segmented scans along an axis of n
    voxels: the doubling steps d = 1, 2, 4, ... < min(n, max_run) reach
    2^ceil(log2 min(n, max_run)) - 1 voxels, forward and then back."""
    m = n if max_run is None else min(n, max_run)
    return 0 if m <= 1 else (1 << (m - 1).bit_length()) - 1


def flood_plan(shape, connectivity: int, max_run: int | None, full: bool,
               elem_bytes: int) -> list:
    """The passes of one flood round over a tensor of ``shape`` seen as a
    3D (n0, n1, n2) array (leading unit axes for 1D and 2D):
    ``("neighbor", side, mid)`` and ``("runs", axis, radius, fold)``.

    The neighbour pass takes the offsets with lo <= |o|_1 <= hi, (1, 3)
    for the min round's full window (``full``) and (2, connectivity)
    otherwise, as bits by in-plane class d (0 centre, 1 axial, 2
    diagonal): ``side`` those of the planes either side (|o|_1 = 1 + d),
    ``mid`` those of the voxel's own plane. Where the set is empty
    (connectivity 1) the first run pass folds it in (``fold``: off-mask
    voxels read as the identity). Each axis whose window min(W, n - 1) is
    not 0 takes run passes of radius <= FLOOD_RADIUS[elem_bytes]."""
    lo, hi = (1, 3) if full else (2, connectivity)
    side = sum(1 << d for d in range(3) if lo <= 1 + d <= hi)
    mid = sum(1 << d for d in (1, 2) if lo <= d <= hi)
    fold = lo > hi
    steps = [] if fold else [("neighbor", side, mid)]
    shape3 = (1,) * (3 - len(shape)) + tuple(shape)
    for axis, n in enumerate(shape3):
        w = min(run_window(n, max_run), n - 1)
        while w > 0:
            r = min(w, FLOOD_RADIUS[elem_bytes])
            steps.append(("runs", axis, r, fold and len(steps) == 0))
            w -= r
    return steps or [("neighbor", side, mid)]


def _flood_round(name: str, cur: torch.Tensor, mask: torch.Tensor,
                 connectivity: int, max_run: int | None,
                 full: bool) -> torch.Tensor:
    _require(mask, f"{name} mask", (torch.bool,))
    if not 1 <= cur.ndim <= 3 or mask.shape != cur.shape \
            or mask.device != cur.device:
        raise ValueError(f"{name}: cur and mask must share a 1-3D shape and "
                         f"a device, got {tuple(cur.shape)} on {cur.device} "
                         f"and {tuple(mask.shape)} on {mask.device}")
    if not 1 <= connectivity <= cur.ndim \
            or (max_run is not None and max_run < 1):
        raise ValueError(f"{name}: connectivity 1..{cur.ndim} and max_run "
                         f"None or >= 1 required, got {connectivity}, "
                         f"{max_run}")
    if cur.numel() == 0:
        return cur.clone()
    lib = _build.load()
    shape3 = (1,) * (3 - cur.ndim) + tuple(cur.shape)
    elem = cur.element_size()
    steps = flood_plan(cur.shape, connectivity, max_run, full, elem)
    bufs = [torch.empty_like(cur) for _ in range(min(2, len(steps)))]
    src, stream = cur, _stream(cur)
    for i, step in enumerate(steps):
        # the last pass writes bufs[0]; no pass writes what it reads
        dst = bufs[(len(steps) - 1 - i) % 2]
        if step[0] == "neighbor":
            err = lib.hf_flood_neighbor(src.data_ptr(), mask.data_ptr(),
                                        dst.data_ptr(), elem, *shape3,
                                        step[1], step[2], stream)
        else:
            _, axis, radius, fold = step
            n = shape3[axis]
            inner = int(np.prod(shape3[axis + 1:]))
            err = lib.hf_flood_runs(src.data_ptr(), mask.data_ptr(),
                                    dst.data_ptr(), elem, cur.numel() // n,
                                    n, inner, radius, int(fold), stream)
        _build.check(lib, err, name)
        src = dst
    return bufs[0]


def flood_min(cur: torch.Tensor, mask: torch.Tensor, connectivity: int,
              max_run: int | None = None) -> torch.Tensor:
    """One round of labeling's min flood (``label``,
    ``segstats.rank_labels``) over an int32 1-3D ``cur`` and a bool
    ``mask`` (csrc/flood.cu), bitwise labeling._min_round_plain: the
    3^ndim window where connectivity == ndim, else the offsets with
    2 <= |o|_1 <= connectivity, then each axis's run window."""
    _require(cur, "flood_min cur", (torch.int32,))
    out = _flood_round("flood_min", cur, mask, connectivity, max_run,
                       connectivity == cur.ndim)
    flood_min.launches += 1
    return out


def flood_reach(cur: torch.Tensor, mask: torch.Tensor, connectivity: int,
                max_run: int | None = None) -> torch.Tensor:
    """One round of labeling.flood_reach over a bool (or uint8 0/1) 1-3D
    ``cur`` and a bool ``mask`` (csrc/flood.cu), bitwise
    labeling._reach_round_plain: the OR over the offsets with
    2 <= |o|_1 <= connectivity, then each axis's run window."""
    _require(cur, "flood_reach cur", (torch.bool, torch.uint8))
    out = _flood_round("flood_reach", cur, mask, connectivity, max_run,
                       False)
    flood_reach.launches += 1
    return out


KERNELS = (nlm, lpcv2d, label_stats, label_lookup, stats_cm, lpcv3d,
           flood_min, flood_reach)


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0
    # of label_lookup's launches, those of the int32 store
    label_lookup.launches_i32 = 0


reset_launches()


def launch_counts() -> dict:
    """Launches per kernel since the last reset, and label_lookup's int32
    stores among them (``label_lookup_i32``)."""
    return {**{k.__name__: k.launches for k in KERNELS},
            "label_lookup_i32": label_lookup.launches_i32}
