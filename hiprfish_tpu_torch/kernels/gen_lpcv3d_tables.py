"""Write csrc/lpcv3d_tables.cuh, the constant tables of kernel B6.

    python -m hiprfish_tpu_torch.kernels.gen_lpcv3d_tables

The header holds ``line_table_3d(11, 9, 9)`` as the X-macro
``HF_LP3D_LINES(L, S)``, one ``L(t, S(x, y, z), ...)`` per orientation with
its 11 samples as literals, so that the kernel turns every sample into a
shared-memory load at a compile-time offset; and the quartile selection
network over the 72 orientation ratios as the X-macro
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


def header_text() -> str:
    table = lp.line_table_3d(PATCH, THETA, PHI)
    n_orient = table.shape[0]
    (lo25, hi25, _), (lo75, hi75, _) = lp.quartile_ranks(n_orient)
    net = lp.selection_network(n_orient, (lo25, hi25, lo75, hi75))
    rows = []
    for t in range(n_orient):
        cells = ", ".join("S(%d, %d, %d)" % tuple(int(v) for v in table[t, s])
                          for s in range(PATCH))
        rows.append(f"  L({t}, {cells})")
    lines_macro = " \\\n".join(rows)
    pairs = [f"CX({a}, {b})" for a, b in net]
    lines = [" ".join(pairs[i:i + 8]) for i in range(0, len(pairs), 8)]
    select = " \\\n  ".join(lines)
    return f"""\
// Generated by `python -m hiprfish_tpu_torch.kernels.gen_lpcv3d_tables`;
// do not edit by hand.
//
// HF_LP3D_LINES(L, S): line_table_3d({PATCH}, {THETA}, {PHI}) of
// hiprfish_tpu/ops/line_profile.py. L(t, s_0, ..., s_{PATCH - 1}) for each
// orientation t, where s_k = S(x, y, z) is the coordinate of sample k within
// the {PATCH}^3 patch; the voxel itself is at ({PATCH // 2}, {PATCH // 2}, \
{PATCH // 2}), which is sample
// {PATCH // 2} of every orientation.
//
// HF_LP3D_SELECT(CX): selection_network({n_orient}, ({lo25}, {hi25}, {lo75}, \
{hi75})) of
// hiprfish_tpu/ops/lp3d_pallas.py, {len(net)} compare-exchanges. Applied in
// order (CX(a, b) leaves min in a, max in b), they put the k-th smallest of
// the {n_orient} values at index k for k in
// {{{lo25}, {hi25}, {lo75}, {hi75}}}.
#pragma once

#define HF_LP3D_NORIENT {n_orient}
#define HF_LP3D_PATCH {PATCH}
#define HF_LP3D_LO25 {lo25}
#define HF_LP3D_HI25 {hi25}
#define HF_LP3D_LO75 {lo75}
#define HF_LP3D_HI75 {hi75}

#define HF_LP3D_LINES(L, S) \\
{lines_macro}

#define HF_LP3D_SELECT(CX) \\
  {select}
"""


if __name__ == "__main__":
    HEADER.write_text(header_text())
    print(f"wrote {HEADER}")
