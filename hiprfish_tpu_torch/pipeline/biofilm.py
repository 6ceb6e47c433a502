"""Biofilm 2D analysis (torch port of hiprfish_tpu/pipeline/biofilm.py):
the LP-CV engine's biofilm variant (adjacency flood, epithelial area), the
per-cell measurement and classification, the debris filter, the taxon
identification images and the barcode x barcode contact matrices.

Artifacts of ``measure_biofilm_images_2d`` (into the current directory):
{sample}_registered.npy, _seg.npy, _adjacency_seg.npy,
_epithelial_area.npy, _avgint.csv, _cell_information.csv,
_cell_information_filtered.csv, _avgint_filtered.csv,
_identification_filtered.npy, _identification(_filtered).png,
_adjacency_matrix(_filtered).csv. The CSVs are written with numpy in the
bytes pandas' to_csv gives; the PNGs are the RGB images at their own size,
without the reference's scale bar (``pixel_um``, given or read from the
first CZI's Scaling metadata as the reference does, is not drawn).
"""

from __future__ import annotations

import glob
from typing import NamedTuple

import numpy as np
import torch

from hiprfish_tpu_torch.config import SEVEN_BIT, SegmentationConfig
from hiprfish_tpu_torch.io import czi
from hiprfish_tpu_torch.io import images as iio
from hiprfish_tpu_torch.io import outputs
from hiprfish_tpu_torch.models import classifier
from hiprfish_tpu_torch.ops import regionprops as rp
from hiprfish_tpu_torch.pipeline import measure, segment2d
from hiprfish_tpu_torch.utils.logging import stage_timer


class TaxonLookup(NamedTuple):
    """Taxon -> (code, HSV colour), one row per distinct (taxon, code)."""

    target_taxon: np.ndarray     # typed as the probe design reads it
    code: np.ndarray             # barcode text
    H: np.ndarray                # float64 hue i / n
    S: np.ndarray                # float64, 1.0
    V: np.ndarray                # float64, 1.0
    sci_name: np.ndarray | None = None

    def columns(self):
        cols = [("target_taxon", self.target_taxon), ("code", self.code),
                ("H", self.H), ("S", self.S), ("V", self.V)]
        if self.sci_name is not None:
            cols.append(("sci_name", self.sci_name))
        return cols

    def save(self, path: str) -> None:
        """taxon_color_lookup.csv: the columns with the row index."""
        outputs.write_frame(path, self.columns(),
                            index=np.arange(len(self.code)))


def make_taxon_lookup(probes: dict, sci_names: dict | None = None
                      ) -> TaxonLookup:
    """The distinct (target_taxon, code) rows of a probe design
    (io/tables.read_probe_design) in first-seen order, with evenly spaced
    hues. ``sci_names`` optionally maps taxid -> scientific name."""
    taxa, codes = probes["target_taxon"], probes["code"]
    taxa_text = outputs.cells_as_text(taxa)
    seen, keep = set(), []
    for i, key in enumerate(zip(taxa_text, codes)):
        if key not in seen:
            seen.add(key)
            keep.append(i)
    n = len(keep)
    names = None
    if sci_names:
        names = np.array([sci_names.get(int(t), str(t)) for t in taxa[keep]],
                         dtype=object)
    return TaxonLookup(taxa[keep], np.asarray(codes)[keep],
                       np.arange(n) / max(n, 1), np.ones(n), np.ones(n),
                       names)


def adjacency_label_pairs(adjacency_seg: np.ndarray) -> np.ndarray:
    """Unique undirected pairs (lo, hi) of 4-adjacent nonzero labels of
    the adjacency segmentation, sorted."""
    seg = np.asarray(adjacency_seg)
    pairs = []
    for a, b in ((seg[:-1, :], seg[1:, :]), (seg[:, :-1], seg[:, 1:])):
        mask = (a != b) & (a > 0) & (b > 0)
        pairs.append(np.stack([a[mask], b[mask]], axis=1))
    pairs = np.concatenate(pairs)
    if pairs.size == 0:
        return np.zeros((0, 2), np.int64)
    return np.unique(np.stack([pairs.min(axis=1), pairs.max(axis=1)],
                              axis=1), axis=0)


def adjacency_matrix_from_pairs(pairs, cell_codes, taxon_lookup,
                                cell_types=None):
    """Barcode x barcode contact counts over the label pairs: (codes,
    matrix, matrix over pairs of two "cell"-typed labels), float64; each
    pair adds one in both directions. Pairs whose label lies past the
    cells, or whose code is not in the lookup, are skipped."""
    codes = [str(c) for c in taxon_lookup.code]
    n = len(codes)
    idx = {c: i for i, c in enumerate(codes)}
    mat = np.zeros((n, n))
    mat_f = np.zeros((n, n))
    n_cells = len(cell_codes)
    for u, v in pairs:
        if u - 1 >= n_cells or v - 1 >= n_cells:
            continue
        cu = str(cell_codes[u - 1]).split("_")[0]
        cv = str(cell_codes[v - 1]).split("_")[0]
        if cu not in idx or cv not in idx:
            continue
        mat[idx[cu], idx[cv]] += 1
        mat[idx[cv], idx[cu]] += 1
        if cell_types is not None and (
                cell_types[u - 1] == "cell" and cell_types[v - 1] == "cell"):
            mat_f[idx[cu], idx[cv]] += 1
            mat_f[idx[cv], idx[cu]] += 1
    return codes, mat, mat_f


def save_adjacency_matrix(path: str, codes, mat: np.ndarray) -> None:
    outputs.write_frame(path, [(c, mat[:, j]) for j, c in enumerate(codes)],
                        index=np.array(codes, dtype=object))


def hsv_to_rgb(hsv) -> np.ndarray:
    """matplotlib.colors.hsv_to_rgb of one (h, s, v) in float64."""
    h, s, v = (np.float64(x) for x in hsv)
    i = int(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    if s == 0:
        return np.array([v, v, v])
    return np.array([(v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v),
                     (v, p, q)][i % 6])


def paint_taxon_identification(segmentation, cell_codes, taxon_lookup,
                               n_cells: int) -> np.ndarray:
    """(H, W, 3) float32 RGB: each cell in its taxon's hue, codes outside
    the lookup white, background black."""
    code_to_rgb = {str(c): hsv_to_rgb((h, s, v)) for c, h, s, v in zip(
        taxon_lookup.code, taxon_lookup.H, taxon_lookup.S, taxon_lookup.V)}
    lut = np.zeros((n_cells + 1, 3), np.float32)
    for i, c in enumerate(cell_codes):
        lut[i + 1] = code_to_rgb.get(str(c).split("_")[0], (1.0, 1.0, 1.0))
    return lut[np.clip(np.asarray(segmentation), 0, n_cells)]


def measure_epithelial_distance(cx, cy, boundary_coords) -> float:
    """Least distance from a centroid to the epithelial boundary points."""
    d = np.sqrt((boundary_coords[:, 0] - cx) ** 2
                + (boundary_coords[:, 1] - cy) ** 2)
    return float(d.min()) if d.size else 0.0


def load_planes(sample: str) -> tuple:
    """(planes, pixel_um): the per-laser planes '{sample}_<laser>.<ext>'
    (.czi or .npy) of a 7-bit FOV, and the lateral pixel size in µm from
    the first CZI's Scaling metadata that has one (None without)."""
    planes, pixel_um = [], None
    for laser in SEVEN_BIT.lasers:
        hits = glob.glob(f"{sample}_{laser}.*")
        if not hits:
            raise FileNotFoundError(f"{sample}_{laser}.(czi|npy)")
        planes.append(iio.load_image(hits[0]))
        if pixel_um is None and hits[0].endswith(".czi"):
            try:
                with czi.CziFile(hits[0]) as f:
                    pixel_um = f.pixel_size_um
            except (ValueError, OSError):
                pixel_um = None
    return planes, pixel_um


def _feature_columns(feats: np.ndarray, nch: int):
    return ([(f"channel_{i}", feats[:, i]) for i in range(nch)]
            + [(f"intensity_classification_{i}", feats[:, nch + i])
               for i in range(feats.shape[1] - nch)])


def measure_biofilm_images_2d(sample: str, clf, taxon_lookup: TaxonLookup,
                              image_stack=None,
                              cfg: SegmentationConfig = SegmentationConfig(),
                              max_cells: int = 4096, save_png: bool = True,
                              pixel_um: float | None = None,
                              device=torch.device("cuda"), timings=None):
    """The biofilm 2D analysis of one FOV with a models/artifacts
    ClassifierArrays; writes the artifact set and returns the cell table
    as [(column, values), ...].

    ``image_stack`` None loads '{sample}_<laser>.czi' or '.npy'; with
    ``pixel_um`` None, the scale bar's pixel size is then the first CZI's
    (0.0675 µm, the reference's, without one; no bar is drawn). The
    arrays go to ``device`` (the card unless the caller names the CPU).
    ``timings``, a dict, receives each stage's seconds."""
    device = torch.device(device)
    lap = stage_timer(timings, device)
    if image_stack is None:
        image_stack, czi_um = load_planes(sample)
        pixel_um = pixel_um if pixel_um is not None else czi_um
    if pixel_um is None:
        pixel_um = 0.0675
    stack = tuple(torch.from_numpy(np.ascontiguousarray(a, np.float32))
                  .to(device) for a in image_stack)
    res = segment2d.segment_lpcv(stack, None, cfg, max_cells, "biofilm")
    n = int(res.n_cells)
    lap("segment")
    seg = res.segmentation.cpu().numpy()
    epithelial = res.epithelial.cpu().numpy()
    np.save(f"{sample}_registered.npy", res.registered.cpu().numpy())
    np.save(f"{sample}_seg.npy", seg)
    np.save(f"{sample}_adjacency_seg.npy", res.adjacency.cpu().numpy())
    np.save(f"{sample}_epithelial_area.npy", epithelial)

    avgint, avgint_norm = measure.measure_fov(
        res.segmentation, res.registered, n, max_cells)
    props = {k: v[1:n + 1].cpu().numpy() for k, v in
             rp.shape_props_2d(res.segmentation, max_cells).items()}
    epi_overlap = rp.label_overlap_any(res.segmentation, res.epithelial,
                                       max_cells)[1:n + 1].cpu().numpy()
    lap("measure")
    avg_cols = [(i, avgint[:, i]) for i in range(avgint.shape[1])]
    outputs.write_frame(f"{sample}_avgint.csv", avg_cols)

    codes, max_prob, probs, feats = classifier.classify(clf, avgint_norm,
                                                        device)
    lap("classify")
    nch = clf.n_channels
    # the debris filter: oversized, touching the epithelial area, or an
    # unsure call
    debris = ((props["area"] > cfg.debris_area_max) | epi_overlap
              | (max_prob <= cfg.debris_prob_min))
    types = np.where(debris, "debris", "cell").astype(object)
    table = (_feature_columns(feats, nch)
             + [("cell_barcode", np.array(codes, dtype=object)),
                ("max_probability", max_prob)]
             + [(f"{name}_prob", probs[:, ci])
                for ci, name in enumerate(clf.codebook)]
             + [("sample", np.full(n, sample, dtype=object)),
                ("label", np.arange(1, n + 1)),
                ("centroid_x", props["centroid_r"]),
                ("centroid_y", props["centroid_c"]),
                ("major_axis", props["major_axis_length"]),
                ("minor_axis", props["minor_axis_length"]),
                ("eccentricity", props["eccentricity"]),
                ("orientation", props["orientation"]),
                ("area", props["area"]),
                ("epithelial_distance", np.zeros(n)),
                ("max_intensity", feats[:, :nch].max(axis=1)
                 if n else np.zeros(0, np.float32)),
                ("type", types)])
    keep = ~debris
    outputs.write_frame(f"{sample}_cell_information.csv", table)
    outputs.write_frame(f"{sample}_cell_information_filtered.csv",
                        [(name, v[keep]) for name, v in table])
    outputs.write_frame(f"{sample}_avgint_filtered.csv",
                        [(i, v[keep]) for i, v in avg_cols])

    ident = paint_taxon_identification(seg, codes, taxon_lookup, n)
    ident_filtered = ident.copy()
    debris_mask = debris[np.clip(seg, 1, max(n, 1)) - 1] & (seg > 0) \
        if n else np.zeros(seg.shape, bool)
    ident_filtered[debris_mask] = [0.5, 0.5, 0.5]
    ident_filtered[epithelial & (seg > 0)] = [0.5, 0.5, 0.5]
    np.save(f"{sample}_identification_filtered.npy", ident_filtered)
    if save_png:
        outputs.write_png(f"{sample}_identification.png",
                          outputs.rgb_bytes(ident))
        outputs.write_png(f"{sample}_identification_filtered.png",
                          outputs.rgb_bytes(ident_filtered))

    pairs = adjacency_label_pairs(res.adjacency.cpu().numpy())
    mcodes, mat, mat_f = adjacency_matrix_from_pairs(pairs, codes,
                                                     taxon_lookup, types)
    save_adjacency_matrix(f"{sample}_adjacency_matrix.csv", mcodes, mat)
    save_adjacency_matrix(f"{sample}_adjacency_matrix_filtered.csv", mcodes,
                          mat_f)
    lap("artifacts")
    return table
