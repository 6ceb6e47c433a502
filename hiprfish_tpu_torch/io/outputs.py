"""Output artifacts and the spectra readers of the CLIs (the port of
hiprfish_tpu/io/outputs.py, with numpy in place of pandas and matplotlib).

Per FOV:
  {sample}_avgint.csv        headerless CSV, np.savetxt's %.18e
  {sample}_avgint_norm.csv   10-bit: as _avgint.csv; 7-bit: a header row
                             0..C-1 and float32 cells, as pandas writes them
  {sample}_seg.npy           int label image
  {sample}_seg.png           label2rgb render
  {sample}_cell_ids.txt      one barcode string per cell
  {sample}_avgint_ids.csv    features + ids (10-bit)
  {sample}_cell_information.csv  the 7-bit cell table
  biofilm: the cell tables, adjacency matrices and taxon colour lookup
           (write_frame: named, typed columns with an optional index),
           and the identification renders (write_png of the RGB image)
  volumes: Blender voxel files (save_bvox, save_identification_bvox) and
           large .npy arrays streamed from a tensor (save_npy)

The CSV writers give the bytes pandas' ``to_csv`` gives: each float cell
as numpy's shortest repr of its dtype (``str(np.float32(v))``), NaN as an
empty field, lines ending in "\\n". The PNGs are 8-bit RGB at the image's
own size (numpy + zlib): the pixels of ``label2rgb``, or matplotlib's
``jet`` over the min-max normalised image. The reference renders a
1500 x 1500 matplotlib figure with a scale bar instead (ROADMAP §C).
"""

from __future__ import annotations

import colorsys
import struct
import zlib

import numpy as np


def save_avgint_csv(path: str, avgint: np.ndarray) -> None:
    """Headerless comma CSV, matching np.savetxt's %.18e default."""
    np.savetxt(path, np.asarray(avgint), delimiter=",")


def _csv_field(s: str) -> str:
    """A CSV field as the csv module's QUOTE_MINIMAL writes it."""
    if any(c in s for c in ',"\n\r'):
        return '"' + s.replace('"', '""') + '"'
    return s


def cells_as_text(values) -> np.ndarray:
    """The text of each cell of an array as pandas' to_csv writes it:
    numbers as numpy's repr of their dtype, NaN empty, strings as they
    are."""
    arr = np.asarray(values)
    text = arr.astype(str)
    if arr.dtype.kind == "f":
        text[np.isnan(arr)] = ""
    elif arr.dtype == object:
        text[np.array([v is None or (isinstance(v, (float, np.floating))
                                     and v != v) for v in arr.flat],
                      bool).reshape(arr.shape)] = ""
    return text


def write_csv(path: str, cells: np.ndarray, header=None) -> None:
    """Write an (n, k) array of text cells (cells_as_text) as CSV rows,
    after an optional header row of column names."""
    lines = [] if header is None else [
        ",".join(_csv_field(str(h)) for h in header)]
    lines += [",".join(_csv_field(v) for v in row) for row in cells]
    with open(path, "w", newline="") as f:
        f.write("".join(line + "\n" for line in lines))


def write_frame(path: str, columns, index=None, header: bool = True) -> None:
    """Named columns [(name, values), ...] as pandas' DataFrame.to_csv
    writes them: each cell as cells_as_text gives it for its column's
    dtype, an index column first (its header cell empty) when ``index``
    holds the row labels, and a header row of the names unless ``header``
    is False."""
    n = len(columns[0][1]) if columns else len(index)
    cells = [cells_as_text(v).reshape(n, 1) for _, v in columns]
    names = [name for name, _ in columns]
    if index is not None:
        cells.insert(0, cells_as_text(index).reshape(n, 1))
        names.insert(0, "")
    write_csv(path, np.concatenate(cells, axis=1) if cells
              else np.zeros((n, 0), str), names if header else None)


def save_avgint_norm_csv_with_header(path: str,
                                     avgint_norm: np.ndarray) -> None:
    """Synthetic-community style: a header row of the column numbers."""
    arr = np.asarray(avgint_norm)
    write_csv(path, cells_as_text(arr), header=range(arr.shape[1]))


def read_spectra_csv(path: str, header: bool = False) -> np.ndarray:
    """(n, C) float64 rows of a spectra CSV, headerless (_avgint.csv) or
    with one header row (_avgint_norm.csv with a header), as pandas'
    read_csv(...).values reads them. A file with no line at all raises
    ValueError, as pandas' EmptyDataError does; a header with no rows
    gives (0, C)."""
    with open(path) as f:
        lines = f.read().splitlines()
    if not lines:
        raise ValueError(f"{path}: no columns to parse from file")
    if header:
        ncols = len(lines[0].split(","))
        lines = lines[1:]
        if not lines:
            return np.zeros((0, ncols), np.float64)
    return np.loadtxt(lines, delimiter=",", ndmin=2, dtype=np.float64)


def label2rgb(labels: np.ndarray, seed: int = 7) -> np.ndarray:
    """Deterministic distinct colors per label, background black."""
    labels = np.asarray(labels)
    n = int(labels.max()) + 1
    rng = np.random.RandomState(seed)
    hues = rng.permutation(n) / max(n, 1)
    lut = np.array(
        [colorsys.hsv_to_rgb(h, 0.9, 1.0) for h in hues], dtype=np.float32
    )
    lut[0] = 0.0
    return lut[np.clip(labels, 0, n - 1)]


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, rgb: np.ndarray) -> None:
    """An (H, W, 3) uint8 image as an 8-bit RGB PNG (filter 0 on every
    row), deflated at zlib level 1: on noisy renders such as the jet
    images the default level 6 took most of the 7-bit measure command
    line's time, for a file only somewhat smaller."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"write_png: expected (H, W, 3), got {rgb.shape}")
    h, w = rgb.shape[0], rgb.shape[1]
    rows = np.zeros((h, 1 + 3 * w), np.uint8)
    rows[:, 1:] = rgb.reshape(h, 3 * w)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0,
                                                0, 0)))
        f.write(_png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 1)))
        f.write(_png_chunk(b"IEND", b""))


def rgb_bytes(rgb: np.ndarray) -> np.ndarray:
    """float RGB in [0, 1] as uint8, rounded to nearest."""
    return np.rint(np.clip(rgb, 0.0, 1.0) * 255.0).astype(np.uint8)


# matplotlib's "jet" segment data: (x, y0, y1) per channel
_JET_DATA = (
    ((0.0, 0, 0), (0.35, 0, 0), (0.66, 1, 1), (0.89, 1, 1), (1.0, 0.5, 0.5)),
    ((0.0, 0, 0), (0.125, 0, 0), (0.375, 1, 1), (0.64, 1, 1), (0.91, 0, 0),
     (1.0, 0, 0)),
    ((0.0, 0.5, 0.5), (0.11, 1, 1), (0.34, 1, 1), (0.65, 0, 0), (1.0, 0, 0)),
)


def _segment_lut(data, n: int = 256) -> np.ndarray:
    """matplotlib's LinearSegmentedColormap table of one channel."""
    a = np.array(data, np.float64)
    x = a[:, 0] * (n - 1)
    y0, y1 = a[:, 1], a[:, 2]
    xind = (n - 1) * np.linspace(0, 1, n)
    ind = np.searchsorted(x, xind)[1:-1]
    distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
    lut = np.concatenate([[y1[0]], distance * (y0[ind] - y1[ind - 1])
                          + y1[ind - 1], [y0[-1]]])
    return np.clip(lut, 0.0, 1.0)


def jet_bytes(normed: np.ndarray) -> np.ndarray:
    """(..., 3) uint8 jet colours of values in [0, 1], as matplotlib's
    colormaps["jet"](normed, bytes=True): index floor(256 x), 1.0 to the
    last entry, the table scaled by 255 and truncated."""
    lut = (np.stack([_segment_lut(d) for d in _JET_DATA], axis=1)
           * 255).astype(np.uint8)
    xa = np.array(normed, np.float64) * 256
    xa[xa == 256] = 255
    return lut[np.clip(xa.astype(np.int64), 0, 255)]


def minmax_normalize(image: np.ndarray) -> np.ndarray:
    """(image - min) / (max - min) in float64, zeros for a constant
    image."""
    img = np.asarray(image, np.float64)
    lo, hi = float(img.min()), float(img.max())
    if hi <= lo:
        return np.zeros_like(img)
    return (img - lo) / (hi - lo)


def save_segmentation(segmentation: np.ndarray, sample: str) -> None:
    """Persist {sample}_seg.npy and its _seg.png label2rgb render."""
    seg = np.asarray(segmentation)
    np.save(sample + "_seg.npy", seg)
    write_png(sample + "_seg.png", rgb_bytes(label2rgb(seg)))


def save_identification_png(labels: np.ndarray, sample: str) -> None:
    """{sample}_identification.png: a barcode-valued label image through
    label2rgb."""
    write_png(sample + "_identification.png",
              rgb_bytes(label2rgb(np.asarray(labels).astype(np.int64))))


def save_sum_png(image: np.ndarray, sample: str,
                 suffix: str = "_sum.png") -> None:
    """{sample}{suffix}: the image in jet over its min-max range."""
    write_png(sample + suffix, jet_bytes(minmax_normalize(image)))


def save_cell_ids(path: str, barcodes) -> None:
    """One barcode string per line."""
    with open(path, "w") as f:
        for b in barcodes:
            f.write(str(b) + "\n")


def save_bvox(volume: np.ndarray, path: str) -> None:
    """Blender voxel file: a little-endian int32 header (nx, ny, nz, 1)
    and the volume as little-endian float32 in Fortran order."""
    vol = np.asarray(volume)
    header = np.array([vol.shape[0], vol.shape[1], vol.shape[2], 1],
                      dtype="<i4")
    with open(path, "wb") as f:
        header.tofile(f)
        vol.flatten("F").astype("<f4").tofile(f)


def save_identification_bvox(image_identification: np.ndarray,
                             sample: str) -> None:
    """{sample}_identification_{r,g,b}.bvox: one volume per colour
    channel of an (X, Y, Z, 3) identification image."""
    for i, c in enumerate("rgb"):
        save_bvox(image_identification[..., i],
                  "{}_identification_{}.bvox".format(sample, c))


def save_npy(path: str, tensor, rows: int = 1 << 27) -> None:
    """np.save of a tensor on any device, copied to the host about
    ``rows`` elements at a time along its first axis into a memory-mapped
    .npy (the same bytes as np.save): a volume on the card never needs a
    whole host copy."""
    import torch

    out = np.lib.format.open_memmap(
        path, mode="w+", shape=tuple(tensor.shape),
        dtype=torch.empty((), dtype=tensor.dtype).numpy().dtype)
    per = max(1, rows // max(1, tensor[:1].numel()))
    for lo in range(0, tensor.shape[0], per):
        out[lo:lo + per] = tensor[lo:lo + per].cpu().numpy()
    out.flush()
    del out
