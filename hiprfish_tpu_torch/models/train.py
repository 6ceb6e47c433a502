"""Classifier training entry points (torch port of
hiprfish_tpu/models/train.py), the reference's ``load_training_data*``
builder family.

Each builder globs measured reference spectra ``*_enc_<n>_avgint.csv``,
fits a per-code mean and covariance, draws the simulations on the device
(one batched GEMM over (codes, simulations, channels)), applies its
variant's augmentation there (excitation adjustment, violet or full
derivative, dimmed negative classes, FRET mixing, code subsets), copies
the training set to the host once, fits the classifier
(models/classifier.train_classifier) and saves one ``.npz`` under the
reference's file name. ``REFERENCE_BUILDERS`` maps every reference builder
name to its builder, as the JAX package's does.

Draws the JAX package makes with jax.random come from one
``torch.Generator(device).manual_seed(seed)``; the draws it makes with
``np.random.RandomState`` (the FRET builder's, the 10-bit dim modes') come
from the same RandomState, in the same order. Every builder takes
``device`` (the card unless the caller names another) and ``seed``.
"""

from __future__ import annotations

import dataclasses
import glob
import os
import re
from typing import Sequence

import numpy as np
import torch

from hiprfish_tpu_torch.config import (
    ChannelLayout,
    ClassifierConfig,
    SEVEN_BIT,
    TEN_BIT,
    convert_code_to_7b,
    convert_code_to_10b,
)
from hiprfish_tpu_torch.io import tables
from hiprfish_tpu_torch.models import simulate as sim
from hiprfish_tpu_torch.models.artifacts import save_classifier
from hiprfish_tpu_torch.models.classifier import train_classifier

CUDA = torch.device("cuda")


# ---------------------------------------------------------------------------
# Reference spectra
# ---------------------------------------------------------------------------


def load_reference_stats(reference_folder: str, pattern: str = "*_avgint.csv"):
    """{enc: (mean (C,), cov (C, C))} of the measured reference CSVs."""
    out = {}
    for f in sorted(glob.glob(os.path.join(reference_folder, pattern))):
        m = re.search(r"enc_([0-9]+)", os.path.basename(f))
        if not m:
            continue
        enc = int(m.group(1))
        rows = np.loadtxt(f, delimiter=",", ndmin=2)
        out[enc] = (rows.mean(axis=0), np.cov(rows.T))
    return out


def check_bits_for_codes(layout: ChannelLayout, code_strings: Sequence[str]):
    """(N, n_checks) ground-truth check bits: OR over each block's bit
    group."""
    bits = np.array([[int(b) for b in c.split("_")[0]] for c in code_strings])
    cols = []
    for group in layout.check_bit_groups:
        cols.append(bits[:, list(group)].max(axis=1))
    return np.stack(cols, axis=1).astype(np.float32)


def _taxon_codes(taxon_lookup):
    """The ``code`` column of a taxon lookup: pipeline/biofilm.TaxonLookup
    (numpy) or a DataFrame."""
    codes = taxon_lookup.code
    return getattr(codes, "values", codes)


def _generator(seed: int, device) -> torch.Generator:
    """Every builder's generator on ``device``. Each builder asks for it
    first, so its simulation GEMMs run in float32 with TF32 off, as
    train_classifier's do."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device=device).manual_seed(seed)


# ---------------------------------------------------------------------------
# Simulation on the device
# ---------------------------------------------------------------------------


def simulate_codes_core(means: torch.Tensor, sqrts: torch.Tensor,
                        z: torch.Tensor) -> torch.Tensor:
    """means (K, C) + z (K, spc, C) @ sqrts (K, C, C)^T, one batched GEMM:
    (K, spc, C) draws."""
    return means[:, None, :] + torch.einsum("ksc,kdc->ksd", z, sqrts)


def _simulate_codes(generator, stats: dict, spc: int, cov_scale: float = 1.0,
                    channel_slice=None, device=CUDA):
    """Multivariate-normal simulations of every code of ``stats`` on
    ``device``: (code per row (K spc,) numpy, draws (K spc, C) tensor)."""
    encs = sorted(stats)
    means = np.stack([stats[e][0] for e in encs]).astype(np.float32)
    covs = np.stack([stats[e][1] for e in encs]).astype(np.float32) \
        * cov_scale
    sqrts = sim.psd_sqrt(covs)
    z = torch.randn((len(encs), spc, means.shape[1]), generator=generator,
                    device=device)
    draws = simulate_codes_core(torch.from_numpy(means).to(device),
                                torch.from_numpy(sqrts).to(device), z)
    del z
    draws = draws.reshape(len(encs) * spc, means.shape[1])
    if channel_slice is not None:
        draws = draws[:, channel_slice[0]:channel_slice[1]]
    return np.repeat(np.asarray(encs), spc), draws


def _excitation_adjust(generator, spectra, blocks, low, high):
    return sim.row_max_normalize(
        sim.excitation_adjust(generator, spectra, blocks, low, high))


def _scale_rows(x: torch.Tensor, lo: int, hi: int, coef) -> None:
    """x[:, lo:hi] *= coef[:, None] in place, for float64 host draws
    ``coef`` and float32 ``x``, rounded as numpy's in-place product is:
    the product in float64, stored as float32."""
    coef = torch.as_tensor(coef, dtype=torch.float64).to(x.device)
    x[:, lo:hi] = (x[:, lo:hi].double() * coef[:, None]).to(x.dtype)


def _host(x: torch.Tensor) -> np.ndarray:
    return x.cpu().numpy()


# ---------------------------------------------------------------------------
# Builders
# ---------------------------------------------------------------------------


def train_simulate_normalized(reference_folder, spc, cfg=ClassifierConfig(),
                              seed=0, save=True, device=CUDA):
    """Plain simulated-spectra classifier, no augmentation."""
    layout = TEN_BIT
    stats = load_reference_stats(reference_folder)
    gen = _generator(seed, device)
    encs, spectra = _simulate_codes(gen, stats, spc, device=device)
    spectra = _host(sim.row_max_normalize(spectra))
    codes = [layout.code_str(e) for e in encs]
    checks = check_bits_for_codes(layout, codes)
    clf = train_classifier(gen, layout, spectra, codes, checks, cfg,
                           device=device)
    if save:
        save_classifier(
            os.path.join(reference_folder,
                         f"reference_simulate_{spc}_normalized.npz"), clf)
    return clf


def train_simulate_normalized_umap_transformed(reference_folder, spc,
                                               cfg=ClassifierConfig(),
                                               seed=0, save=True,
                                               device=CUDA):
    """3x-covariance simulated classifier."""
    layout = TEN_BIT
    stats = load_reference_stats(reference_folder)
    gen = _generator(seed, device)
    encs, spectra = _simulate_codes(gen, stats, spc, cov_scale=3.0,
                                    device=device)
    spectra = _host(sim.row_max_normalize(spectra))
    codes = [layout.code_str(e) for e in encs]
    checks = check_bits_for_codes(layout, codes)
    clf = train_classifier(gen, layout, spectra, codes, checks, cfg,
                           device=device)
    if save:
        save_classifier(
            os.path.join(
                reference_folder,
                f"reference_simulate_{spc}_normalized_umap_transform.npz"), clf)
    return clf


def train_excitation_adjusted(reference_folder, spc, cfg=ClassifierConfig(),
                              seed=0, save=True, device=CUDA):
    """Excitation-adjusted 10-bit classifier, 5 check heads."""
    layout = TEN_BIT
    stats = load_reference_stats(reference_folder)
    gen = _generator(seed, device)
    encs, spectra = _simulate_codes(gen, stats, spc, device=device)
    spectra = sim.row_max_normalize(spectra)
    spectra = _host(_excitation_adjust(
        gen, spectra, layout.blocks,
        cfg.excitation_adjust_low, cfg.excitation_adjust_high))
    codes = [layout.code_str(e) for e in encs]
    checks = check_bits_for_codes(layout, codes)[:, :5]
    clf = train_classifier(gen, layout, spectra, codes, checks, cfg,
                           device=device)
    if save:
        save_classifier(
            os.path.join(
                reference_folder,
                f"reference_simulate_{spc}_excitation_adjusted_normalized_"
                "umap_transform.npz"), clf)
    return clf


def train_excitation_adjusted_violet_derivative(
    reference_folder, spc, cfg=ClassifierConfig(), seed=0, save=True,
    device=CUDA
):
    """The E. coli mix default: excitation adjusted + violet derivative,
    132-d features with 6 check heads."""
    layout = TEN_BIT
    stats = load_reference_stats(reference_folder)
    gen = _generator(seed, device)
    encs, spectra = _simulate_codes(gen, stats, spc, device=device)
    spectra = sim.row_max_normalize(spectra)
    spectra = _excitation_adjust(
        gen, spectra, layout.blocks,
        cfg.excitation_adjust_low, cfg.excitation_adjust_high)
    spectra = _host(sim.violet_derivative(spectra, layout.blocks[0]))
    codes = [layout.code_str(e) for e in encs]
    checks = check_bits_for_codes(layout, codes)  # 6 checks incl. violet
    clf = train_classifier(gen, layout, spectra, codes, checks, cfg,
                           violet_derivative=True, device=device)
    if save:
        save_classifier(
            os.path.join(
                reference_folder,
                f"reference_simulate_{spc}_excitation_adjusted_normalized_"
                "violet_derivative_umap_transform.npz"), clf)
    return clf


def _biofilm_7b_sets(layout, stats, spc, generator, cfg, error_floor=0.4,
                     code_subset=None, device=CUDA):
    """Positive and negative (error-class) 7-bit training sets from 10-bit
    reference stats; ``code_subset`` optionally restricts the 7-bit
    codes."""
    sel = {}
    for enc, ms in stats.items():
        code10 = TEN_BIT.code_str(enc)
        if code10[6] == "0" and code10[5] == "0" and code10[1] == "0":
            if code_subset is not None and \
                    convert_code_to_7b(code10) not in code_subset:
                continue
            sel[enc] = ms
    encs, spectra = _simulate_codes(generator, sel, spc,
                                    channel_slice=(32, 95), device=device)
    spectra = sim.row_max_normalize(spectra)
    pos = _host(_excitation_adjust(
        generator, spectra, layout.blocks,
        cfg.excitation_adjust_low, cfg.excitation_adjust_high))
    codes = [convert_code_to_7b(TEN_BIT.code_str(e)) for e in encs]
    checks = check_bits_for_codes(layout, codes)
    neg = _host(sim.dim_blocks(generator, spectra, layout.blocks,
                               [error_floor] * len(layout.blocks)))
    neg_codes = [c + "_error" for c in codes]
    neg_checks = np.zeros_like(checks)
    return pos, codes, checks, neg, neg_codes, neg_checks


def train_excitation_adjusted_biofilm_7b(reference_folder, spc,
                                         cfg=ClassifierConfig(), seed=0,
                                         save=True, scaler=False,
                                         negatives=True, code_subset=None,
                                         artifact=None, device=CUDA):
    """7-bit biofilm classifier with negative error classes. ``scaler``
    adds the standard scaler, ``negatives=False`` trains the check heads
    on the positives only, ``code_subset`` restricts the 7-bit codes."""
    layout = SEVEN_BIT
    stats = load_reference_stats(reference_folder)
    gen = _generator(seed, device)
    pos, codes, checks, neg, neg_codes, neg_checks = _biofilm_7b_sets(
        layout, stats, spc, gen, cfg, code_subset=code_subset,
        device=device)
    if negatives:
        check_spectra = np.concatenate([pos, neg])
        check_bits_full = np.concatenate([checks, neg_checks])
    else:
        check_spectra = check_bits_full = None
    clf = train_classifier(
        gen, layout, pos, codes, checks, cfg, scaler=scaler,
        check_spectra=check_spectra, check_bits_full=check_bits_full,
        device=device)
    if save:
        save_classifier(
            os.path.join(
                reference_folder,
                artifact or f"reference_simulate_{spc}_excitation_adjusted_"
                "normalized_umap_transform_biofilm_7b.npz"), clf)
    return clf


def train_excitation_adjusted_scaled_biofilm_7b(reference_folder, spc,
                                                cfg=ClassifierConfig(),
                                                seed=0, save=True,
                                                device=CUDA):
    """Scaled variant."""
    return train_excitation_adjusted_biofilm_7b(
        reference_folder, spc, cfg, seed, save, scaler=True,
        artifact=f"reference_simulate_{spc}_excitation_adjusted_normalized_"
                 "scaled_umap_transform_biofilm_7b.npz", device=device)


def train_excitation_adjusted_biofilm_7b_error_threshold(
        reference_folder, spc, cfg=ClassifierConfig(), seed=0, save=True,
        code_subset=None, device=CUDA):
    """Error-threshold variant: U(0.4, 1) per-block excitation, check heads
    on the positives only (with ``code_subset``, the "_limited"
    variant)."""
    cfg4 = dataclasses.replace(cfg, excitation_adjust_low=0.4)
    tag = "" if code_subset is None else "select_DSGN0524_"
    return train_excitation_adjusted_biofilm_7b(
        reference_folder, spc, cfg4, seed, save, negatives=False,
        code_subset=code_subset,
        artifact=f"reference_simulate_{spc}_excitation_adjusted_normalized_"
                 f"{tag}umap_transform_biofilm_7b.npz", device=device)


def train_excitation_adjusted_biofilm_7b_limited(reference_folder, spc,
                                                 taxon_lookup,
                                                 cfg=ClassifierConfig(),
                                                 seed=0, save=True,
                                                 device=CUDA):
    """Taxon-restricted biofilm classifier (``taxon_lookup`` has the 7-bit
    ``code`` column: pipeline/biofilm.TaxonLookup or a DataFrame)."""
    return train_excitation_adjusted_biofilm_7b(
        reference_folder, spc, cfg, seed, save, negatives=False,
        code_subset=set(str(c) for c in _taxon_codes(taxon_lookup)),
        artifact=f"reference_simulate_{spc}_excitation_adjusted_normalized_"
                 "select_DSGN0524_umap_transform_biofilm_7b.npz",
        device=device)


def train_excitation_adjusted_biofilm_7b_dsgn(reference_folder, spc,
                                              probe_design_file,
                                              cfg=ClassifierConfig(),
                                              seed=0, save=True,
                                              device=CUDA):
    """Probe-design-restricted biofilm classifier."""
    probes = tables.read_probe_design(probe_design_file)
    return train_excitation_adjusted_biofilm_7b(
        reference_folder, spc, cfg, seed, save,
        code_subset=set(np.unique(probes["code"])),
        artifact=f"reference_simulate_{spc}_DSGN_excitation_adjusted_"
                 "normalized_umap_transform_biofilm_7b.npz", device=device)


def train_fret_biofilm_7b(
    reference_folder,
    fret_folder=None,
    spc=2000,
    cfg=ClassifierConfig(),
    seed=0,
    save=True,
    code_subset: Sequence[str] | None = None,
    probe_design_filename: str | None = None,
    fluorophore_barcodes=(512, 128, 64, 32, 4, 2, 1),
    fret_distance: float | None = None,
    excitation_adjust: bool = True,
    negatives: bool = True,
    artifact: str | None = None,
    device=CUDA,
):
    """FRET/reabsorption-simulated 7-bit classifier with a scaler. The
    single-fluorophore spectra come from the 7 one-hot barcodes'
    reference CSVs; the Foerster distance is U(6, 10) per simulated row
    (drawn from the generator), or ``fret_distance`` for every row.

    Per code, RandomState(seed + 1) draws the fluorophores' normals, then
    each block's excitation coefficients, then the negatives' dimming, in
    the reference's order; the mixing, normalisation and scaling run on
    the device from those draws."""
    layout = SEVEN_BIT
    stats = load_reference_stats(reference_folder)
    missing = [b for b in fluorophore_barcodes if b not in stats]
    if missing:
        raise FileNotFoundError(
            f"single-fluorophore reference spectra missing for enc {missing}")
    if probe_design_filename is not None:
        probes = tables.read_probe_design(probe_design_filename)
        code_subset = set(np.unique(probes["code"]))
    gen = _generator(seed, device)

    n_bits = layout.n_bits
    c10 = stats[fluorophore_barcodes[0]][0].shape[0]
    means = np.stack([stats[b][0] for b in fluorophore_barcodes]).astype(
        np.float32)
    covs = np.stack([stats[b][1] for b in fluorophore_barcodes]).astype(
        np.float32)
    # the 7-bit channels are the 10-bit range [32:95]
    sl = slice(32, 95) if c10 == 95 else slice(0, layout.n_channels)
    chols = sim.psd_sqrt(covs)

    if fret_distance is None:
        dists = 6.0 + 4.0 * _host(torch.rand(spc, generator=gen,
                                             device=device))
        fret = np.stack([sim.fret_transfer_matrix(float(d)) for d in dists])
    else:
        fret = np.broadcast_to(sim.fret_transfer_matrix(float(fret_distance)),
                               (spc, n_bits, n_bits))

    fret_t = torch.from_numpy(np.ascontiguousarray(fret)).to(device)
    exc = torch.from_numpy(sim.EXCITATION_MATRIX_7B).to(device)
    means_t = torch.from_numpy(means).to(device)
    chols_t = torch.from_numpy(chols).to(device)
    indices = layout.block_bounds
    all_spectra, all_codes = [], []
    neg_spectra = []
    rng = np.random.RandomState(seed + 1)
    for enc in range(1, 2**n_bits):
        code = layout.code_str(enc)
        if code_subset is not None and code not in code_subset:
            continue
        bits = np.array([int(a) for a in code], np.float32)
        error_scale = [0.25, 0.25, 0.35, 0.45] if bits[6] \
            else [0.1, 0.25, 0.35, 0.45]
        # per-fluorophore draws, reused across lasers for this code
        z = torch.from_numpy(rng.randn(n_bits, spc, c10).astype(np.float32))
        draws = simulate_codes_core(means_t, chols_t, z.to(device))
        spectra = sim.fret_mix(draws[:, :, sl], torch.from_numpy(bits).to(
            device), fret_t, exc, layout.blocks)
        norm = sim.row_max_normalize(spectra)
        adj = norm.clone()
        if excitation_adjust:
            # an intensity floor: rows whose block would fall below the
            # error scale keep their block
            for b in range(4):
                lo, hi = indices[b], indices[b + 1]
                coefc = torch.from_numpy(
                    error_scale[b] + (1 - error_scale[b]) * rng.rand(spc)
                ).to(device)
                max_int = adj[:, lo:hi].amax(dim=1).double()
                coefc = torch.where(coefc * max_int < error_scale[b], 1.0,
                                    coefc)
                _scale_rows(adj, lo, hi, coefc)
        else:
            # the plain reabsorption variants: U(0.3, 1) per block
            for b in range(4):
                _scale_rows(adj, indices[b], indices[b + 1],
                            0.3 + 0.7 * rng.rand(spc))
        all_spectra.append(sim.row_max_normalize(adj))
        all_codes.extend([code] * spc)
        # the negative class: blocks dimmed to U(0, error_scale)
        negs = norm.clone()
        for b in range(4):
            _scale_rows(negs, indices[b], indices[b + 1],
                        error_scale[b] * rng.rand(spc))
        neg_spectra.append(negs)

    pos = _host(torch.cat(all_spectra))
    checks = check_bits_for_codes(layout, all_codes)
    if negatives:
        neg = _host(torch.cat(neg_spectra))
        neg_checks = np.zeros((neg.shape[0], checks.shape[1]), np.float32)
        check_spectra = np.concatenate([pos, neg])
        check_bits_full = np.concatenate([checks, neg_checks])
    else:
        check_spectra = check_bits_full = None
    del all_spectra, neg_spectra
    clf = train_classifier(
        gen, layout, pos, all_codes, checks, cfg, scaler=True,
        check_spectra=check_spectra, check_bits_full=check_bits_full,
        device=device)
    if save:
        tag = "" if code_subset is None else "DSGN_"
        save_classifier(
            os.path.join(
                reference_folder,
                artifact or f"reference_simulate_{spc}_{tag}interaction_"
                "simulated_excitation_adjusted_normalized_umap_transform_"
                "biofilm_7b.npz"),
            clf)
    return clf


def train_reabsorption_biofilm_7b(reference_folder, fret_folder=None,
                                  spc=2000, cfg=ClassifierConfig(), seed=0,
                                  save=True, code_subset=None, device=CUDA):
    """Fixed-distance reabsorption variant, no excitation floor, no
    negatives (with ``code_subset``, the "_limited" variant)."""
    # the "_limited" artifact carries a select_DSGN0524 infix, which
    # downstream loaders key on
    tag = "" if code_subset is None else "select_DSGN0524_"
    return train_fret_biofilm_7b(
        reference_folder, fret_folder, spc, cfg, seed, save,
        code_subset=code_subset, fret_distance=5.0,
        excitation_adjust=False, negatives=False,
        artifact=f"reference_simulate_{spc}_interaction_simulated_{tag}"
                 "umap_transform_biofilm_7b.npz", device=device)


def train_reabsorption_excitation_adjusted_biofilm_7b(
        reference_folder, fret_folder=None, spc=2000, cfg=ClassifierConfig(),
        seed=0, save=True, device=CUDA):
    """Fixed-distance reabsorption with the excitation floor."""
    return train_fret_biofilm_7b(
        reference_folder, fret_folder, spc, cfg, seed, save,
        fret_distance=5.0, excitation_adjust=True, negatives=False,
        artifact=f"reference_simulate_{spc}_interaction_simulated_"
                 "excitation_adjusted_umap_transform_biofilm_7b.npz",
        device=device)


def _mix_id(input_tab_filename: str) -> str:
    m = re.search(r"mix_([0-9]+)", input_tab_filename)
    return m.group(1) if m else "0"


def train_simulate_normalized_select(reference_folder, spc, input_tab_filename,
                                     cfg=ClassifierConfig(), seed=0, save=True,
                                     device=CUDA):
    """Classifier restricted to the barcodes of a mix table."""
    layout = TEN_BIT
    wanted = set(tables.read_mix_barcodes(input_tab_filename))
    stats = {e: ms for e, ms in load_reference_stats(
        reference_folder, "*_avgint_norm.csv").items() if e in wanted}
    gen = _generator(seed, device)
    encs, spectra = _simulate_codes(gen, stats, spc, cov_scale=3.0,
                                    device=device)
    spectra = _host(sim.row_max_normalize(spectra))
    codes = [layout.code_str(e) for e in encs]
    checks = check_bits_for_codes(layout, codes)
    clf = train_classifier(gen, layout, spectra, codes, checks, cfg,
                           device=device)
    if save:
        save_classifier(
            os.path.join(
                reference_folder,
                f"reference_simulate_select_mix_{_mix_id(input_tab_filename)}"
                f"_{spc}_normalized_umap_transform.npz"), clf)
    return clf


def _train_tenbit_variant(reference_folder, spc, cfg=ClassifierConfig(),
                          seed=0, save=True, *, pattern="*_avgint.csv",
                          cov_scale=1.0, normalize=True,
                          full_derivative=False, dim_mode=None,
                          code_filter=None, mean_normalized=False,
                          artifact=None, device=CUDA):
    """The engine of the 10-bit ``load_training_data_simulate*`` family:

      cov_scale        1x or 3x the measured covariance
      normalize        row-max normalisation of the draws
      full_derivative  append np.diff over all channels
      dim_mode         None | "block5_soft": 6 copies, each with one laser
                       block dimmed by U(0.7, 1) | "noise_free": the
                       measured means, every block dimmed by U(0.5, 1)
      code_filter      restrict to a barcode subset
      mean_normalized  normalise the measured mean before simulating

    The dim modes draw from RandomState(seed + 7)."""
    layout = TEN_BIT
    stats = load_reference_stats(reference_folder, pattern)
    if code_filter is not None:
        wanted = set(int(c) for c in code_filter)
        stats = {e: ms for e, ms in stats.items() if e in wanted}
    if mean_normalized:
        stats = {e: (m / max(m.max(), 1e-12), c) for e, (m, c) in
                 stats.items()}
    gen = _generator(seed, device)
    if dim_mode == "noise_free":
        encs = np.repeat(sorted(stats), spc)
        spectra = torch.from_numpy(np.stack(
            [stats[e][0] for e in sorted(stats)]).astype(np.float32)
            .repeat(spc, axis=0)).to(device)
    else:
        encs, spectra = _simulate_codes(gen, stats, spc, cov_scale=cov_scale,
                                        device=device)
    if normalize:
        spectra = sim.row_max_normalize(spectra)
    rng = np.random.RandomState(seed + 7)
    bounds = layout.block_bounds
    if dim_mode == "block5_soft":
        copies = [spectra]
        for b in range(len(bounds) - 1):
            adj = spectra.clone()
            _scale_rows(adj, bounds[b], bounds[b + 1],
                        0.7 + 0.3 * rng.rand(len(adj)))
            copies.append(sim.row_max_normalize(adj))
        spectra = torch.cat(copies)
        encs = np.tile(encs, len(bounds))
    elif dim_mode == "noise_free":
        for b in range(len(bounds) - 1):
            _scale_rows(spectra, bounds[b], bounds[b + 1],
                        0.5 + 0.5 * rng.rand(len(spectra)))
        spectra = sim.row_max_normalize(spectra)
    if full_derivative:
        spectra = torch.cat([spectra, torch.diff(spectra, dim=1)], dim=1)
    spectra = _host(spectra)
    codes = [layout.code_str(int(e)) for e in encs]
    checks = check_bits_for_codes(layout, codes)
    clf = train_classifier(gen, layout, spectra, codes, checks, cfg,
                           full_derivative=full_derivative, device=device)
    if save and artifact:
        save_classifier(os.path.join(reference_folder, artifact), clf)
    return clf


def train_simulate(reference_folder, spc, cfg=ClassifierConfig(), seed=0,
                   save=True, device=CUDA):
    """Unnormalised simulated classifier."""
    return _train_tenbit_variant(
        reference_folder, spc, cfg, seed, save, normalize=False,
        artifact=f"reference_simulate_{spc}.npz", device=device)


def train_simulate_normalized_custom_kernel(reference_folder, spc,
                                            cfg=ClassifierConfig(), seed=0,
                                            save=True, device=CUDA):
    """The custom-kernel SVC variant: the gated block-cosine kNN is that
    kernel, so only the artifact name differs from
    train_simulate_normalized."""
    return _train_tenbit_variant(
        reference_folder, spc, cfg, seed, save,
        artifact=f"reference_simulate_{spc}_normalized.npz", device=device)


def train_simulate_normalized_biofilm_select(reference_folder, spc,
                                             taxon_lookup,
                                             cfg=ClassifierConfig(), seed=0,
                                             save=True, device=CUDA):
    """Taxon-restricted 3x-covariance classifier; ``taxon_lookup``'s
    7-bit ``code`` column goes through convert_code_to_10b."""
    wanted = [int(convert_code_to_10b(c), 2)
              for c in _taxon_codes(taxon_lookup)]
    return _train_tenbit_variant(
        reference_folder, spc, cfg, seed, save, cov_scale=3.0,
        code_filter=wanted,
        artifact=f"reference_simulate_{spc}_normalized_umap_transform.npz",
        device=device)


def train_simulate_normalized_differentiated(reference_folder, spc,
                                             cfg=ClassifierConfig(), seed=0,
                                             save=True, device=CUDA):
    """3x covariance + full-spectrum derivative features."""
    return _train_tenbit_variant(
        reference_folder, spc, cfg, seed, save, cov_scale=3.0,
        full_derivative=True,
        artifact=f"reference_simulate_{spc}_normalized_umap_transform.npz",
        device=device)


def train_excitation_adjusted_differentiated(reference_folder, spc,
                                             cfg=ClassifierConfig(), seed=0,
                                             save=True, device=CUDA):
    """Per-block dimming (6 copies) + full-spectrum derivative."""
    return _train_tenbit_variant(
        reference_folder, spc, cfg, seed, save, cov_scale=3.0,
        dim_mode="block5_soft", full_derivative=True,
        artifact=f"reference_simulate_{spc}_excitation_adjusted_normalized_"
                 "umap_transform.npz", device=device)


def train_excitation_adjusted_noise_free(reference_folder, spc,
                                         cfg=ClassifierConfig(), seed=0,
                                         save=True, device=CUDA):
    """Noise-free means with per-block U(0.5, 1) excitation dimming."""
    return _train_tenbit_variant(
        reference_folder, spc, cfg, seed, save, dim_mode="noise_free",
        artifact=f"reference_simulate_{spc}_excitation_adjusted_normalized_"
                 "umap_transform.npz", device=device)


def train_simulate_normalized_select_excitation_adjusted(
        reference_folder, spc, input_tab_filename, cfg=ClassifierConfig(),
        seed=0, save=True, device=CUDA):
    """Mix-restricted, mean-normalised, per-block dimming."""
    return _train_tenbit_variant(
        reference_folder, spc, cfg, seed, save,
        pattern="*_avgint_norm.csv", cov_scale=3.0, mean_normalized=True,
        dim_mode="block5_soft",
        code_filter=tables.read_mix_barcodes(input_tab_filename),
        artifact=f"reference_simulate_select_mix_"
                 f"{_mix_id(input_tab_filename)}_{spc}_excitation_"
                 "adjusted_normalized_umap_transform.npz", device=device)


def train_simulate_select(reference_folder, spc, input_tab_filename,
                          cfg=ClassifierConfig(), seed=0, save=True,
                          device=CUDA):
    """Mix-restricted classifier on mean-normalised draws."""
    return _train_tenbit_variant(
        reference_folder, spc, cfg, seed, save, mean_normalized=True,
        code_filter=tables.read_mix_barcodes(input_tab_filename),
        artifact=f"reference_simulate_select_mix_"
                 f"{_mix_id(input_tab_filename)}_{spc}.npz", device=device)


def train_direct(reference_folder, cfg=ClassifierConfig(), seed=0, save=True,
                 device=CUDA):
    """Classifier on the measured reference rows themselves, no
    simulation."""
    layout = TEN_BIT
    rows_all, codes = [], []
    for f in sorted(glob.glob(os.path.join(reference_folder, "*_avgint.csv"))):
        m = re.search(r"enc_([0-9]+)", os.path.basename(f))
        if not m:
            continue
        rows = np.loadtxt(f, delimiter=",", ndmin=2)
        rows = rows / np.maximum(rows.max(axis=1, keepdims=True), 1e-12)
        rows_all.append(rows.astype(np.float32))
        codes.extend([layout.code_str(int(m.group(1)))] * rows.shape[0])
    spectra = np.concatenate(rows_all)
    checks = check_bits_for_codes(layout, codes)
    clf = train_classifier(_generator(seed, device), layout, spectra, codes,
                           checks, cfg, device=device)
    if save:
        save_classifier(os.path.join(reference_folder, "reference_all.npz"),
                        clf)
    return clf


# ---------------------------------------------------------------------------
# Reference builder-name registry
# ---------------------------------------------------------------------------

#: Every ``load_training_data*`` builder of the reference trainer mapped to
#: its builder here (the JAX package's registry, name for name).
REFERENCE_BUILDERS = {
    "load_training_data_simulate_normalized":
        train_simulate_normalized,
    "load_training_data_simulate_normalized_umap_transformed":
        train_simulate_normalized_umap_transformed,
    "load_training_data_simulate_normalized_biofilm_select_umap_transformed":
        train_simulate_normalized_biofilm_select,
    "load_training_data_simulate_normalized_differentiated_umap_transformed":
        train_simulate_normalized_differentiated,
    "load_training_data_simulate":
        train_simulate,
    "load_training_data_simulate_normalized_custom_kernel":
        train_simulate_normalized_custom_kernel,
    "load_training_data_simulate_excitation_adjusted_normalized_"
    "umap_transformed":
        train_excitation_adjusted,
    "load_training_data_simulate_excitation_adjusted_normalized_"
    "violet_derivative_umap_transformed":
        train_excitation_adjusted_violet_derivative,
    "load_training_data_simulate_excitation_adjusted_normalized_"
    "umap_transformed_biofilm_7b":
        train_excitation_adjusted_biofilm_7b,
    "load_training_data_simulate_excitation_adjusted_normalized_scaled_"
    "umap_transformed_biofilm_7b":
        train_excitation_adjusted_scaled_biofilm_7b,
    "load_training_data_simulate_excitation_adjusted_normalized_"
    "umap_transformed_biofilm_7b_DSGN":
        train_excitation_adjusted_biofilm_7b_dsgn,
    "load_training_data_simulate_excitation_adjusted_normalized_"
    "umap_transformed_error_threshold_biofilm_7b":
        train_excitation_adjusted_biofilm_7b_error_threshold,
    "load_training_data_simulate_excitation_adjusted_normalized_"
    "umap_transformed_error_threshold_biofilm_7b_limited":
        lambda folder, spc, taxon_lookup, **kw:
            train_excitation_adjusted_biofilm_7b_error_threshold(
                folder, spc,
                code_subset=set(str(c) for c in _taxon_codes(taxon_lookup)),
                **kw),
    "load_training_data_simulate_reabsorption_umap_transformed_biofilm_7b":
        train_reabsorption_biofilm_7b,
    "load_training_data_simulate_reabsorption_umap_transformed_limited_"
    "biofilm_7b":
        lambda folder, fret_folder, spc, code_subset, **kw:
            train_reabsorption_biofilm_7b(folder, fret_folder, spc,
                                          code_subset=code_subset, **kw),
    "load_training_data_simulate_reabsorption_excitation_adjusted_"
    "umap_transformed_biofilm_7b":
        train_reabsorption_excitation_adjusted_biofilm_7b,
    "load_training_data_simulate_reabsorption_excitation_adjusted_"
    "umap_transformed_with_fret_biofilm_7b":
        train_fret_biofilm_7b,
    "load_training_data_simulate_reabsorption_excitation_adjusted_"
    "umap_transformed_with_fret_biofilm_7b_limited":
        lambda folder, fret_folder, spc, probe_design_filename, **kw:
            train_fret_biofilm_7b(
                folder, fret_folder, spc,
                probe_design_filename=probe_design_filename, **kw),
    "load_training_data_simulate_excitation_adjusted_normalized_"
    "umap_transformed_biofilm_7b_limited":
        train_excitation_adjusted_biofilm_7b_limited,
    "load_training_data_simulate_excitation_adjusted_normalized_noise_free_"
    "umap_transformed":
        train_excitation_adjusted_noise_free,
    "load_training_data_simulate_excitation_adjusted_normalized_"
    "differentiated_umap_transformed":
        train_excitation_adjusted_differentiated,
    "load_training_data_simulate_normalized_select":
        train_simulate_normalized_select,
    "load_training_data_simulate_normalized_select_excitation_adjusted":
        train_simulate_normalized_select_excitation_adjusted,
    "load_training_data_simulate_select":
        train_simulate_select,
    "load_training_data":
        train_direct,
}
