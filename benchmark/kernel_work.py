"""The yardstick of the kernels' roofline shares: the operations and bytes
each of the port's hand-written kernels must at least do on given inputs,
and the least time an NVIDIA H100 could take for them. A frozen copy of
``chip_smoke.kernel_work`` / ``bound`` and the constants they read; it
imports nothing of the port.
"""

from __future__ import annotations

from plainref import line_profile as lp

# the card's peaks (NVIDIA H100 SXM data sheet, dense, at 700 W): f32
# outside the tensor cores, and HBM3 bandwidth
PEAK_OPS = 67e12
PEAK_BYTES = 3.35e12
# B1 per pixel and offset: squared difference 2, box sum as running column
# and row sums 4, weight 3, two accumulations 3 each
OPS_NLM = 15
# the fewest compare-exchanges known to sort n = 0 .. 17 values (Knuth,
# TAOCP vol. 3, 5.3.4, and later searches; proven optimal up to n = 12)
BEST_SORT = (0, 0, 1, 3, 5, 9, 12, 16, 19, 25, 29, 35, 39, 45, 51, 56, 60, 71)


def _network_ops(n: int) -> int:
    """2 ops per compare-exchange of the fewest known to put the
    interpolated quartiles' ranks of n values in place."""
    (lo25, hi25, _), (lo75, hi75, _) = lp.quartile_ranks(n)
    n_cx = len(lp.selection_network(n, (lo25, hi25, lo75, hi75)))
    if n < len(BEST_SORT):
        n_cx = min(n_cx, BEST_SORT[n])
    return 2 * n_cx


def ops_lpcv2d(patch: int = 11, phi: int = 9) -> int:
    """B2's operations per pixel: phi x (patch - 1) x 2 min/max, phi
    ratios x 4, the mean phi, the quartile network, the combine 6."""
    return phi * (patch - 1) * 2 + phi * 4 + phi + _network_ops(phi) + 6


def ops_lpcv3d(patch: int = 11, theta: int = 9, phi: int = 9) -> int:
    """B6's operations per voxel over its (theta - 1) phi orientations, as
    ops_lpcv2d, the combine 10."""
    n = (theta - 1) * phi
    return n * (patch - 1) * 2 + n * 4 + n + _network_ops(n) + 10


def kernel_work(name: str, **a) -> tuple[float, float]:
    """(operations, bytes) that kernel ``name`` must at least do on the
    given inputs: each input byte read once and each output byte written
    once. The label kernels count only the ``labelled`` pixels' channel
    rows (``row_bytes`` each) and one add per column of each;
    ``px_bytes`` are other per-pixel inputs (aux, mask)."""
    if name == "nlm":
        pd = a["pd"]
        px = a["h"] * a["w"]
        return px * ((2 * pd + 1) ** 2 - 1) // 2 * OPS_NLM, 8 * px
    if name == "lpcv2d":
        px = a["h"] * a["w"]
        return px * ops_lpcv2d(a.get("patch", 11), a.get("phi", 9)), 8 * px
    if name == "lpcv3d":
        cfg = (a.get("patch", 11), a.get("theta", 9), a.get("phi", 9))
        return a["voxels"] * ops_lpcv3d(*cfg), 8 * a["voxels"]
    if name == "label_lookup":
        return a["pixels"], 8 * a["pixels"] + 4 * a["segments"]
    if name in ("label_stats", "stats_cm"):
        n, lab, ncols = a["pixels"], a["labelled"], a["ncols"]
        return lab * ncols, (n * (4 + a.get("px_bytes", 0))
                             + lab * a["row_bytes"]
                             + 4 * a["segments"] * ncols)
    raise ValueError(f"kernel_work: unknown kernel {name}")


def bound(ops: float, nbytes: float) -> tuple[float, str]:
    """(ms, "operations" or "bytes"): the least time the card could take,
    the larger of the operations over the f32 peak and the bytes over the
    memory rate."""
    t_ops, t_bytes = ops / PEAK_OPS, nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")
