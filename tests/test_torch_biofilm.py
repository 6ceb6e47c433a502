"""Port parity for the biofilm 2D engine and its measurement against the
JAX package on the CPU, at 192^2 (the 7-bit FOV of
tests/test_biofilm_and_3d.py, seed 5, six cells):

- segment2d.segment_lpcv(..., "biofilm") on the plain FOV at the default
  configuration (no epithelial area), on the FOV with two bright slabs
  planted at bkg_min_size=200, epithelial_disk_radius=6 (14,113 epithelial
  pixels), and on the slab FOV with watershed_max_iters=20, where the
  capped, unmasked flood of the epithelial area leaves 26,496 pixels
  unreached and so flagged: equal n_cells, labels, adjacency labels and
  epithelial masks, equal registered cubes, and the enhanced surface
  within atol 1e-4 inside the cells;
- pipeline/biofilm.measure_biofilm_images_2d on the slab FOV: every .npy
  artifact equal, every CSV byte-identical except the classifier's
  probability columns (see same_csv);
- the taxon lookup, adjacency pairs and matrices, the HSV colours and the
  identification painter against the JAX package and matplotlib.
"""

import csv
import os

import numpy as np
import pandas as pd
import pytest
import torch

from hiprfish_tpu.config import SEVEN_BIT as JSEVEN_BIT
from hiprfish_tpu.config import SegmentationConfig as JConfig
from hiprfish_tpu.models.artifacts import load_classifier as jload
from hiprfish_tpu.pipeline import biofilm as jbiofilm
from hiprfish_tpu.pipeline import segment2d as jsegment2d
from hiprfish_tpu.utils import synthetic as jsynthetic
from hiprfish_tpu_torch.config import SegmentationConfig
from hiprfish_tpu_torch.io import tables
from hiprfish_tpu_torch.models.artifacts import load_classifier
from hiprfish_tpu_torch.pipeline import biofilm, segment2d

torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "torch_port_clf_7b_127x50.npz")
CODES = [1, 9, 65, 127, 34, 88]
MAX_CELLS = 128
SLAB = dict(bkg_min_size=200, epithelial_disk_radius=6)
CONFIGS = {"plain": ("plain", {}), "slab": ("slab", SLAB),
           "slab_capped": ("slab", dict(SLAB, watershed_max_iters=20))}
EPITHELIAL_PX = {"plain": 0, "slab": 14113, "slab_capped": 26496}


def fov_stack(kind="plain"):
    """The seed-5 FOV's four planes; "slab" adds 0.5 x each plane's maximum
    on all rows of columns 0-39 and on rows 150-191 of columns 120-191."""
    stack = jsynthetic.make_fov(JSEVEN_BIT, CODES, shape=(192, 192), seed=5,
                                cell_axes=(7.0, 12.0))["stack"]
    if kind == "slab":
        stack = [p.copy() for p in stack]
        for p in stack:
            add = 0.5 * p.max()
            p[:, 0:40] += add
            p[150:192, 120:192] += add
    return stack


def write_probe_design(path, codes=CODES):
    """A probe design as pandas writes it: one row per code, a repeated
    row, and text codes with leading zeros."""
    taxa = [100 + i for i in range(len(codes))]
    code_str = [JSEVEN_BIT.code_str(c) for c in codes]
    pd.DataFrame({"target_taxon": taxa + taxa[:1],
                  "code": code_str + code_str[:1],
                  "probe": [f"p{i}" for i in range(len(codes) + 1)]}
                 ).to_csv(path, index=False)


def _is_prob(name):
    return name == "max_probability" or name.endswith("_prob")


def same_csv(port, ref):
    """Byte-identical files, except the cells of the classifier's
    probability columns (max_probability, <code>_prob), which agree within
    rtol 1e-4: the kNN vote's distances and exp round in an order the
    reference's CPU program picks per shape (ROADMAP §C)."""
    a, b = open(port, "rb").read(), open(ref, "rb").read()
    if a == b:
        return
    ra = list(csv.reader(open(port, newline="")))
    rb = list(csv.reader(open(ref, newline="")))
    assert ra[0] == rb[0] and len(ra) == len(rb), port
    probs = [j for j, name in enumerate(ra[0]) if _is_prob(name)]
    assert probs, port
    for x, y in zip(ra[1:], rb[1:]):
        assert [v for j, v in enumerate(x) if j not in probs] \
            == [v for j, v in enumerate(y) if j not in probs], port
        np.testing.assert_allclose([float(x[j]) for j in probs],
                                   [float(y[j]) for j in probs],
                                   rtol=1e-4, atol=0)
    # the text differs in the probability cells only
    assert a.replace(b"\r", b"").count(b",") == b.replace(b"\r", b"") \
        .count(b",")


@pytest.fixture(scope="module")
def engines():
    out = {}
    for name, (kind, kw) in CONFIGS.items():
        stack = fov_stack(kind)
        jr = jsegment2d.segment_lpcv(stack, None, JConfig(**kw), MAX_CELLS,
                                     "biofilm")
        tr = segment2d.segment_lpcv(tuple(torch.from_numpy(a) for a in stack),
                                    None, SegmentationConfig(**kw), MAX_CELLS,
                                    "biofilm")
        out[name] = (jr, tr)
    return out


@pytest.mark.parametrize("name", list(CONFIGS))
def test_biofilm_labels_equal_jax(engines, name):
    jr, tr = engines[name]
    assert int(tr.n_cells) == int(jr.n_cells) >= len(CODES)
    assert tr.segmentation.dtype == tr.adjacency.dtype == torch.int32
    np.testing.assert_array_equal(tr.segmentation.numpy(),
                                  np.asarray(jr.segmentation))
    np.testing.assert_array_equal(tr.adjacency.numpy(),
                                  np.asarray(jr.adjacency))
    assert int(tr.adjacency.max()) == int(jr.n_cells)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_biofilm_epithelial_area_equals_jax(engines, name):
    jr, tr = engines[name]
    assert tr.epithelial.dtype == torch.bool
    np.testing.assert_array_equal(tr.epithelial.numpy(),
                                  np.asarray(jr.epithelial))
    assert int(tr.epithelial.sum()) == EPITHELIAL_PX[name]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_biofilm_surfaces_equal_jax(engines, name):
    jr, tr = engines[name]
    np.testing.assert_array_equal(tr.registered.numpy(),
                                  np.asarray(jr.registered))
    np.testing.assert_allclose(tr.fov_sum.numpy(), np.asarray(jr.fov_sum),
                               rtol=1e-6, atol=0)
    cells = np.asarray(jr.segmentation) > 0
    np.testing.assert_allclose(tr.enhanced.numpy()[cells],
                               np.asarray(jr.enhanced)[cells], rtol=0,
                               atol=1e-4)


def test_unknown_variant_raises():
    with pytest.raises(ValueError, match="unknown variant"):
        segment2d.segment_lpcv([torch.zeros(8, 8, 2)], variant="biofim")


NPY = ("_registered.npy", "_seg.npy", "_adjacency_seg.npy",
       "_epithelial_area.npy", "_identification_filtered.npy")
CSV = ("_avgint.csv", "_avgint_filtered.csv", "_cell_information.csv",
       "_cell_information_filtered.csv", "_adjacency_matrix.csv",
       "_adjacency_matrix_filtered.csv")


@pytest.fixture(scope="module")
def measured(tmp_path_factory):
    """measure_biofilm_images_2d of both packages on the slab FOV, each in
    its own directory: (port dir, jax dir, port cell table)."""
    root = tmp_path_factory.mktemp("biofilm_measure")
    write_probe_design(root / "probes.csv")
    stack = fov_stack("slab")
    old = os.getcwd()
    try:
        os.chdir(root)
        os.mkdir("jax")
        os.chdir("jax")
        jbiofilm.measure_biofilm_images_2d(
            "s", jload(FIXTURE),
            jbiofilm.make_taxon_lookup(
                pd.read_csv(root / "probes.csv", dtype={"code": str})),
            image_stack=stack, cfg=JConfig(**SLAB), max_cells=MAX_CELLS,
            save_png=False)
        os.chdir(root)
        os.mkdir("port")
        os.chdir("port")
        table = biofilm.measure_biofilm_images_2d(
            "s", load_classifier(FIXTURE),
            biofilm.make_taxon_lookup(
                tables.read_probe_design(str(root / "probes.csv"))),
            image_stack=stack, cfg=SegmentationConfig(**SLAB),
            max_cells=MAX_CELLS, device="cpu")
    finally:
        os.chdir(old)
    return root / "port", root / "jax", dict(table)


@pytest.mark.parametrize("suffix", NPY)
def test_measure_npy_artifacts_equal_jax(measured, suffix):
    port, jax_dir, _ = measured
    got, want = np.load(port / f"s{suffix}"), np.load(jax_dir / f"s{suffix}")
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("suffix", CSV)
def test_measure_csv_artifacts_equal_jax(measured, suffix):
    port, jax_dir, _ = measured
    same_csv(port / f"s{suffix}", jax_dir / f"s{suffix}")


def test_measure_debris_filter_and_pngs(measured):
    """The slab cells overlap the epithelial area and are debris; the
    filtered render greys them; the PNGs hold the renders at full size."""
    from tests.test_torch_io import decode_png

    port, _, table = measured
    types = table["type"]
    assert 0 < (types == "cell").sum() < (types == "debris").sum()
    ident = np.load(port / "s_identification_filtered.npy")
    seg = np.load(port / "s_seg.npy")
    epi = np.load(port / "s_epithelial_area.npy")
    assert (ident[epi & (seg > 0)] == 0.5).all()
    for name in ("s_identification.png", "s_identification_filtered.png"):
        assert decode_png(port / name).shape == (192, 192, 3)
    np.testing.assert_array_equal(
        decode_png(port / "s_identification_filtered.png"),
        np.rint(np.clip(ident, 0, 1) * 255).astype(np.uint8))


def test_taxon_lookup_equals_jax(tmp_path):
    path = tmp_path / "probes.csv"
    write_probe_design(path)
    got = biofilm.make_taxon_lookup(tables.read_probe_design(str(path)),
                                    {100: "Genus a"})
    want = jbiofilm.make_taxon_lookup(pd.read_csv(path, dtype={"code": str}),
                                      {100: "Genus a"})
    assert [n for n, _ in got.columns()] == list(want.columns)
    for name, values in got.columns():
        np.testing.assert_array_equal(values, want[name].to_numpy())
    got.save(str(tmp_path / "port.csv"))
    want.to_csv(tmp_path / "jax.csv")
    assert (tmp_path / "port.csv").read_bytes() \
        == (tmp_path / "jax.csv").read_bytes()


def test_adjacency_pairs_and_matrices_equal_jax():
    rng = np.random.RandomState(12)
    seg = rng.randint(0, 9, (24, 30)).astype(np.int32)
    seg[rng.rand(24, 30) < 0.3] = 0
    pairs = biofilm.adjacency_label_pairs(seg)
    np.testing.assert_array_equal(pairs, jbiofilm.adjacency_label_pairs(seg))
    codes = [JSEVEN_BIT.code_str(c) for c in (1, 9, 65, 1, 127, 9, 3)]
    types = np.array(["cell", "debris", "cell", "cell", "cell", "debris",
                      "cell"], dtype=object)
    lookup_df = jbiofilm.make_taxon_lookup(pd.DataFrame({
        "target_taxon": [1, 2, 3, 4],
        "code": [JSEVEN_BIT.code_str(c) for c in (1, 9, 65, 127)]}))
    lookup = biofilm.TaxonLookup(
        lookup_df.target_taxon.to_numpy(), lookup_df.code.to_numpy(),
        lookup_df.H.to_numpy(), lookup_df.S.to_numpy(), lookup_df.V.to_numpy())
    mcodes, mat, mat_f = biofilm.adjacency_matrix_from_pairs(
        pairs, codes, lookup, types)
    jmat, jmat_f = jbiofilm.adjacency_matrix_from_pairs(pairs, codes,
                                                        lookup_df, types)
    assert mcodes == list(jmat.index)
    np.testing.assert_array_equal(mat, jmat.to_numpy())
    np.testing.assert_array_equal(mat_f, jmat_f.to_numpy())
    assert mat.sum() > mat_f.sum() > 0


def test_identification_and_hsv_equal_matplotlib():
    from matplotlib.colors import hsv_to_rgb

    for h in np.arange(13) / 13:
        np.testing.assert_array_equal(biofilm.hsv_to_rgb((h, 1.0, 1.0)),
                                      hsv_to_rgb([h, 1.0, 1.0]))
    lookup_df = jbiofilm.make_taxon_lookup(pd.DataFrame({
        "target_taxon": [1, 2, 3],
        "code": [JSEVEN_BIT.code_str(c) for c in (1, 9, 65)]}))
    lookup = biofilm.TaxonLookup(
        lookup_df.target_taxon.to_numpy(), lookup_df.code.to_numpy(),
        lookup_df.H.to_numpy(), lookup_df.S.to_numpy(), lookup_df.V.to_numpy())
    seg = np.random.RandomState(13).randint(0, 5, (16, 20)).astype(np.int32)
    codes = [JSEVEN_BIT.code_str(c) for c in (9, 127, 1, 65)]
    got = biofilm.paint_taxon_identification(seg, codes, lookup, 4)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(
        got, jbiofilm.paint_taxon_identification(seg, codes, lookup_df, 4))
    pts = np.random.RandomState(14).rand(30, 2) * 50
    assert biofilm.measure_epithelial_distance(3.0, 4.0, pts) \
        == jbiofilm.measure_epithelial_distance(3.0, 4.0, pts)
