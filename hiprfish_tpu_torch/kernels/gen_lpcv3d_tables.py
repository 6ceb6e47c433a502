"""Write the constant tables of kernel B6 as a CUDA header.

    python -m hiprfish_tpu_torch.kernels.gen_lpcv3d_tables

writes csrc/lpcv3d_tables.cuh, the default configuration's header
(patch_size 11, theta_range 9, phi_range 9). For any other configuration
the build writes ``header_text(patch, theta, phi)`` into its build
directory and compiles one more instance of csrc/lpcv3d.cu from it
(kernels/_build.py::load_lpcv3d).

The header holds ``line_table_3d(patch, theta, phi)`` as the X-macro
``HF_LP3D_LINES(L, S)``, one ``L(t, S(x, y, z), ...)`` per orientation with
its ``patch`` samples as literals, so that the kernel turns every sample
into a shared-memory load at a compile-time offset; ``HF_LP3D_EACH(M,
...)``, which applies M to the samples after the first; and the quartile
selection network over the orientation ratios as the X-macro
``HF_LP3D_SELECT(CX)``, one ``CX(a, b)`` compare-exchange per pair, so that
the kernel indexes its register arrays with literal constants. Tests hold
the committed header equal to this module's output and to the reference's
tables.
"""

from __future__ import annotations

from pathlib import Path

from hiprfish_tpu_torch.ops import line_profile as lp

PATCH, THETA, PHI = 11, 9, 9
HEADER = Path(__file__).resolve().parent.parent / "csrc" / \
    "lpcv3d_tables.cuh"


def header_text(patch: int = PATCH, theta: int = THETA,
                phi: int = PHI) -> str:
    if patch < 3 or patch % 2 != 1 or theta < 2 or phi < 1:
        raise ValueError("gen_lpcv3d_tables: odd patch >= 3, theta_range "
                         ">= 2 and phi_range >= 1 required")
    table = lp.line_table_3d(patch, theta, phi)
    n_orient = table.shape[0]
    (lo25, hi25, _), (lo75, hi75, _) = lp.quartile_ranks(n_orient)
    net = lp.selection_network(n_orient, (lo25, hi25, lo75, hi75))
    rows = []
    for t in range(n_orient):
        cells = ", ".join("S(%d, %d, %d)" % tuple(int(v) for v in table[t, s])
                          for s in range(patch))
        rows.append(f"  L({t}, {cells})")
    lines_macro = " \\\n".join(rows)
    args = ", ".join(f"a{k}" for k in range(1, patch))
    each = " ".join(f"M(a{k})" for k in range(1, patch))
    pairs = [f"CX({a}, {b})" for a, b in net]
    lines = [" ".join(pairs[i:i + 8]) for i in range(0, len(pairs), 8)]
    select = " \\\n  ".join(lines)
    return f"""\
// Generated by `python -m hiprfish_tpu_torch.kernels.gen_lpcv3d_tables`;
// do not edit by hand.
//
// HF_LP3D_LINES(L, S): line_table_3d({patch}, {theta}, {phi}) of
// hiprfish_tpu/ops/line_profile.py. L(t, s_0, ..., s_{patch - 1}) for each
// orientation t, where s_k = S(x, y, z) is the coordinate of sample k within
// the {patch}^3 patch; the voxel itself is at ({patch // 2}, {patch // 2}, \
{patch // 2}), which is sample
// {patch // 2} of every orientation. HF_LP3D_EACH(M, s_1, ..., s_{patch - 1})
// is M(s_1) ... M(s_{patch - 1}).
//
// HF_LP3D_SELECT(CX): selection_network({n_orient}, ({lo25}, {hi25}, {lo75}, \
{hi75})) of
// hiprfish_tpu/ops/lp3d_pallas.py, {len(net)} compare-exchanges. Applied in
// order (CX(a, b) leaves min in a, max in b), they put the k-th smallest of
// the {n_orient} values at index k for k in
// {{{lo25}, {hi25}, {lo75}, {hi75}}}.
#pragma once

#define HF_LP3D_NORIENT {n_orient}
#define HF_LP3D_PATCH {patch}
#define HF_LP3D_THETA {theta}
#define HF_LP3D_PHI {phi}
#define HF_LP3D_LO25 {lo25}
#define HF_LP3D_HI25 {hi25}
#define HF_LP3D_LO75 {lo75}
#define HF_LP3D_HI75 {hi75}

#define HF_LP3D_EACH(M, {args}) {each}

#define HF_LP3D_LINES(L, S) \\
{lines_macro}

#define HF_LP3D_SELECT(CX) \\
  {select}
"""


if __name__ == "__main__":
    HEADER.write_text(header_text())
    print(f"wrote {HEADER}")
