"""Spectral training-set simulation on the device (torch port of
hiprfish_tpu/models/simulate.py).

Multivariate-normal draws around measured per-barcode spectra, per-laser
block excitation adjustment, the violet derivative, dimmed negative
blocks, and FRET mixing of single-fluorophore spectra through a Foerster
transfer matrix. The numpy helpers (``psd_sqrt``, the photophysics
constants, ``default_fluorophore_curves``, ``fret_transfer_matrix``) are
copies of the reference's, bit for bit. Every random function takes a
``torch.Generator`` on the tensors' device and has a deterministic core
(``*_core``) that takes the drawn normals or uniforms, so a test can feed
it the reference's draws.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Core samplers
# ---------------------------------------------------------------------------


def psd_sqrt(cov: np.ndarray) -> np.ndarray:
    """Symmetric square root of a (possibly rank-deficient) covariance by
    eigendecomposition with the eigenvalues clipped at 0 (measured
    covariances are singular when a code has fewer cells than channels).
    Batched over (..., C, C); float32."""
    cov = np.asarray(cov, np.float64)
    cov = (cov + np.swapaxes(cov, -1, -2)) / 2.0
    w, v = np.linalg.eigh(cov)
    w = np.clip(w, 0.0, None)
    return (v * np.sqrt(w)[..., None, :]).astype(np.float32)


def mvnormal_core(mean: torch.Tensor, sqrt: torch.Tensor,
                  z: torch.Tensor) -> torch.Tensor:
    """mean + z @ sqrt.T for standard normals z (n, C)."""
    return mean[None, :] + z @ sqrt.T


def mvnormal(generator: torch.Generator, mean: torch.Tensor, cov,
             n: int) -> torch.Tensor:
    """(n, C) multivariate-normal draws through the PSD square root."""
    sqrt = torch.from_numpy(psd_sqrt(np.asarray(cov))).to(mean.device)
    z = torch.randn((n, mean.shape[-1]), generator=generator,
                    device=mean.device)
    return mvnormal_core(mean, sqrt, z)


def row_max_normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.amax(x, dim=-1, keepdim=True), min=1e-12)


def excitation_adjust_core(spectra: torch.Tensor, blocks, low: float,
                           high: float, u: torch.Tensor) -> torch.Tensor:
    """Block b of every row scaled by low + (high - low) u[b] for
    uniforms u (n_blocks, n, 1)."""
    out = spectra.clone()
    for b, (lo, hi) in enumerate(blocks):
        out[:, lo:hi] *= low + (high - low) * u[b]
    return out


def excitation_adjust(generator: torch.Generator, spectra: torch.Tensor,
                      blocks, low: float, high: float) -> torch.Tensor:
    """Random per-laser-block brightness: each block of each row scaled
    by U(low, high)."""
    u = torch.rand((len(blocks), spectra.shape[0], 1), generator=generator,
                   device=spectra.device)
    return excitation_adjust_core(spectra, blocks, low, high, u)


def dim_blocks_core(spectra: torch.Tensor, blocks, scales: Sequence[float],
                    u: torch.Tensor) -> torch.Tensor:
    """Block b of every row scaled by scales[b] u[b] for uniforms u
    (n_blocks, n, 1)."""
    out = spectra.clone()
    for b, ((lo, hi), s) in enumerate(zip(blocks, scales)):
        out[:, lo:hi] *= s * u[b]
    return out


def dim_blocks(generator: torch.Generator, spectra: torch.Tensor, blocks,
               scales: Sequence[float]) -> torch.Tensor:
    """Negative ('error') class: block b of each row scaled by
    U(0, scales[b])."""
    u = torch.rand((len(blocks), spectra.shape[0], 1), generator=generator,
                   device=spectra.device)
    return dim_blocks_core(spectra, blocks, scales, u)


def violet_derivative(spectra: torch.Tensor, block=(0, 32)) -> torch.Tensor:
    """Append np.diff of the violet block."""
    lo, hi = block
    return torch.cat([spectra, torch.diff(spectra[:, lo:hi], dim=1)], dim=1)


# ---------------------------------------------------------------------------
# FRET / reabsorption physics
# ---------------------------------------------------------------------------

# per-fluorophore photophysics constants
MOLAR_EXTINCTION = (73000.0, 112000.0, 120000.0, 144000.0, 270000.0,
                    50000.0, 81000.0)
QUANTUM_YIELD = (0.92, 0.79, 1.0, 0.33, 0.33, 1.0, 0.61)

# which fluorophores each of the 4 lasers excites
EXCITATION_MATRIX_7B = np.array(
    [
        [1, 1, 0, 0, 1, 1, 1],
        [1, 1, 0, 0, 1, 1, 1],
        [0, 1, 1, 1, 1, 1, 0],
        [0, 0, 1, 1, 0, 0, 0],
    ],
    np.float32,
)


def default_fluorophore_curves(n: int = 7, n_wl: int = 401,
                               wl_lo: float = 400.0, wl_hi: float = 800.0):
    """Synthetic excitation and emission curves standing in for measured
    ones: Gaussian excitation and Stokes-shifted emission, peaks spread
    over the visible range in descending-wavelength fluorophore order."""
    wl = np.linspace(wl_lo, wl_hi, n_wl)
    exc = np.zeros((n, n_wl))
    emi = np.zeros((n, n_wl))
    peaks = np.linspace(wl_hi - 120, wl_lo + 40, n)
    for i, p in enumerate(peaks):
        exc[i] = np.exp(-((wl - p) ** 2) / (2 * 25.0**2))
        emi[i] = np.exp(-((wl - (p + 30.0)) ** 2) / (2 * 30.0**2))
    return wl, exc, emi


def fret_transfer_matrix(
    distance: float,
    wavelengths: np.ndarray | None = None,
    excitation: np.ndarray | None = None,
    emission: np.ndarray | None = None,
    kappa_squared: float = 2.0 / 3.0,
    refractive_index: float = 1.4,
) -> np.ndarray:
    """7x7 signed Foerster transfer matrix: J-overlap of donor emission
    with acceptor excitation, the R0^6 law, the sign of the transfer by
    emission order."""
    if wavelengths is None:
        wavelengths, excitation, emission = default_fluorophore_curves()
    n = excitation.shape[0]
    avogadro = 6.022e23
    prefactor = (
        2.07 * kappa_squared * 1.0
        / (128 * np.pi**5 * refractive_index**4 * avogadro)
        * 1e17
    )
    out = np.eye(n)
    for i in range(n):
        for j in range(n):
            if i == j:
                continue
            em_max_i = wavelengths[np.argmax(emission[i])]
            em_max_j = wavelengths[np.argmax(emission[j])]
            if em_max_i < em_max_j:
                donor, acceptor = i, j
            else:
                donor, acceptor = j, i
            d_em = emission[donor] / max(emission[donor].sum(), 1e-30)
            a_ex = np.clip(excitation[acceptor]
                           / max(excitation[acceptor].max(), 1e-30), 0, 1)
            j_overlap = float(np.sum(d_em * a_ex * wavelengths**4))
            r0 = (
                prefactor
                * j_overlap
                * MOLAR_EXTINCTION[acceptor]
                * QUANTUM_YIELD[donor]
            ) ** (1.0 / 6.0)
            eff = 1.0 / (1.0 + (distance / max(r0, 1e-9)) ** 6)
            out[i, j] = np.sign(em_max_i - em_max_j) * eff
    return out


def fret_mix(draws: torch.Tensor, code_bits: torch.Tensor,
             fret_matrices: torch.Tensor, excitation_matrix: torch.Tensor,
             blocks) -> torch.Tensor:
    """(n, C) spectra of one barcode from per-fluorophore draws (n_bits,
    n, C): per laser, the excited fluorophores of the code mix through
    each row's FRET matrix (n, n_bits, n_bits), and the laser's block
    comes from its own mix. Computed in the FRET matrices' dtype, cast to
    the draws'."""
    n_bits, n, c = draws.shape
    spectra = torch.zeros((n, c), dtype=draws.dtype, device=draws.device)
    draws = draws.to(fret_matrices.dtype)
    for exc in range(excitation_matrix.shape[0]):
        relevant = (code_bits * excitation_matrix[exc]).to(
            fret_matrices.dtype)
        coeff = torch.einsum("nij,j->ni", fret_matrices, relevant) * relevant
        mixed = torch.einsum("ni,inc->nc", coeff, draws)
        lo, hi = blocks[exc]
        spectra[:, lo:hi] = mixed[:, lo:hi].to(spectra.dtype)
    return spectra


def simulate_fret_code_spectra_core(code_bits, fluor_means, fluor_chols,
                                    fret_matrices, excitation_matrix, blocks,
                                    z: torch.Tensor) -> torch.Tensor:
    """FRET-coupled spectra of one barcode from standard normals z
    (n_bits, n_sim, C)."""
    draws = fluor_means[:, None, :] + torch.einsum("knc,kdc->knd", z,
                                                   fluor_chols)
    return fret_mix(draws, code_bits, fret_matrices, excitation_matrix,
                    blocks)


def simulate_fret_code_spectra(
    generator: torch.Generator,
    code_bits: torch.Tensor,          # (n_bits,) 0/1
    fluor_means: torch.Tensor,        # (n_bits, C) single-fluorophore means
    fluor_chols: torch.Tensor,        # (n_bits, C, C) covariance roots
    fret_matrices: torch.Tensor,      # (n_sim, n_bits, n_bits)
    excitation_matrix: torch.Tensor,  # (n_lasers, n_bits)
    blocks,
    n_sim: int,
) -> torch.Tensor:
    """FRET-coupled spectra for one barcode: independent draws per
    fluorophore, mixed per laser (``fret_mix``)."""
    n_bits, c = fluor_means.shape
    z = torch.randn((n_bits, n_sim, c), generator=generator,
                    device=fluor_means.device)
    return simulate_fret_code_spectra_core(
        code_bits, fluor_means, fluor_chols, fret_matrices,
        excitation_matrix, blocks, z)
