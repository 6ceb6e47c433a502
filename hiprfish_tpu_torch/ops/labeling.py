"""Connected-component labeling by iterative min-label propagation, and
the label-table filters built on it (torch port of
hiprfish_tpu/ops/labeling.py).

Every fixpoint loop keeps the reference's cap and exit rule: stop when an
iteration changed nothing or after ``max_iters`` iterations. The loops
(``flood_reach``, ``label``, ``segstats.rank_labels`` and
``watershed.watershed``) hand their round, a pure function of the loop
state, to one driver, ``_fixpoint``. On the CPU and for 3D tensors it runs
the rounds one by one and reads each round's change test back to the host
(through ``utils.logging.host_wait``). For a 2D CUDA tensor it replays
CUDA graphs of ``_GRAPH_ROUNDS`` rounds that write their change flags to
the card and reads the flags once a replay. Each run of a loop is a span
(``flood.ccl``, ``flood.rank``, ``flood.reach``, ``flood.watershed``)
whose ``rounds`` is the loop's iteration count.

The min and reach rounds run on CUDA tensors as the hand-written kernels
of ``csrc/flood.cu`` (``kernels.flood_min``, ``kernels.flood_reach``),
bitwise the plain bodies ``_min_round_plain`` and ``_reach_round_plain``,
which every other device takes; their spans' ``kernel`` attribute says
which ran.
"""

from __future__ import annotations

import itertools

import torch
import torch.autograd.profiler as _tap

from hiprfish_tpu_torch import kernels
from hiprfish_tpu_torch.utils.logging import host_wait, span

_INF = 2**30


def _neighbor_shifts(ndim: int, connectivity: int):
    """Offsets of the neighborhood (excluding center)."""
    shifts = []
    for off in itertools.product((-1, 0, 1), repeat=ndim):
        if all(o == 0 for o in off):
            continue
        if sum(abs(o) for o in off) <= connectivity:
            shifts.append(off)
    return shifts


def shifted(arr: torch.Tensor, off, fill) -> torch.Tensor:
    """out[p] = arr[p - off], ``fill`` where p - off leaves the array."""
    out = torch.full_like(arr, fill)
    dst, src = [], []
    for ax, o in enumerate(off):
        n = arr.shape[ax]
        if abs(o) >= n:
            return out
        if o >= 0:
            dst.append(slice(o, n))
            src.append(slice(0, n - o))
        else:
            dst.append(slice(0, n + o))
            src.append(slice(-o, n))
    out[tuple(dst)] = arr[tuple(src)]
    return out


def _run_min_scan(values: torch.Tensor, mask: torch.Tensor, axis: int,
                  reverse: bool, max_run: int | None = None) -> torch.Tensor:
    """Running min of ``values`` along contiguous True-runs of ``mask``
    (Hillis-Steele doubling, distance capped at ``max_run``)."""
    off = [0] * mask.ndim
    off[axis] = -1 if reverse else 1
    gate = mask & shifted(mask, tuple(off), False)
    n = values.shape[axis]
    if max_run is not None:
        n = min(n, max_run)
    g, v = gate, values
    d = 1
    while d < n:
        off_d = [0] * mask.ndim
        off_d[axis] = -d if reverse else d
        ga = shifted(g, tuple(off_d), False)
        va = shifted(v, tuple(off_d), _INF)
        v = torch.where(g, torch.minimum(va, v), v)
        g = g & ga
        d *= 2
    return torch.where(mask, v, values)


def _run_or_scan(reach: torch.Tensor, mask: torch.Tensor, axis: int,
                 reverse: bool, max_run: int | None = None) -> torch.Tensor:
    """Propagate True along contiguous mask runs (segmented OR-scan)."""
    off = [0] * mask.ndim
    off[axis] = -1 if reverse else 1
    gate = mask & shifted(mask, tuple(off), False)
    n = reach.shape[axis]
    if max_run is not None:
        n = min(n, max_run)
    g, r = gate, reach
    d = 1
    while d < n:
        off_d = [0] * mask.ndim
        off_d[axis] = -d if reverse else d
        ga = shifted(g, tuple(off_d), False)
        ra = shifted(r, tuple(off_d), False)
        r = r | (g & ra)
        g = g & ga
        d *= 2
    return r


def _block_pool(x: torch.Tensor, c: int, op: str) -> torch.Tensor:
    """Factor-c block reduce per axis (padded with False — conservative)."""
    pads = [(-s) % c for s in x.shape]
    if any(pads):
        padded = torch.zeros([s + p for s, p in zip(x.shape, pads)],
                             dtype=x.dtype, device=x.device)
        padded[tuple(slice(0, s) for s in x.shape)] = x
        x = padded
    comb = torch.logical_and if op == "all" else torch.logical_or
    for ax in range(x.ndim):
        sl = [slice(None)] * x.ndim
        r = None
        for k in range(c):
            sl[ax] = slice(k, None, c)
            piece = x[tuple(sl)]
            r = piece if r is None else comb(r, piece)
        x = r
    return x


# Rounds per graph replay. A replay runs up to k - 1 rounds past the
# fixed point (0.7-1.2 ms of device work each on a 2000^2 FOV, ~(k - 1) / 2
# a flood on average) to save host reads, each of which drains the card's
# queue; on the card k = 2 gave more FOVs/s than k = 4 (PERF.md, PR 21).
_GRAPH_ROUNDS = 2
# keys captured (two graphs each) and graph replays in this process,
# counted as the kernel wrappers count their launches
captures = 0
replays = 0
# {key: _Rounds}, and the graph memory pool of each device that all of
# them share (their replays never overlap: one stream, one at a time)
_GRAPHS: dict = {}
_POOLS: dict = {}


def _changed(new, old) -> torch.Tensor:
    """A round's change flag on the device: whether any state tensor
    differs from its value before the round."""
    flag = None
    for a, b in zip(new, old):
        d = (a != b).any()
        flag = d if flag is None else flag | d
    return flag


def _takes_graphs(t: torch.Tensor) -> bool:
    """Whether a loop over ``t`` replays graphs: 2D CUDA tensors. A 3D
    tile's round is a few large kernels of up to 10^8 voxels each, so its
    issue time is small, and graph pools of that size would press on the
    3D pass's out-of-memory ladder; CPU tensors have no graphs."""
    return t.is_cuda and t.ndim == 2


class _Rounds:
    """A fixpoint loop's state and inputs in static buffers, advanced n
    rounds at a time: ``advance(n)`` runs the round n times from the
    buffered state, writes each round's change flag into the device vector
    ``flags`` and the state after the n-th round back into the buffers.
    On a CUDA device ``capture`` records ``advance(k)`` and ``advance(1)``
    as graphs that ``replay(n)`` runs."""

    def __init__(self, body, state, consts, k: int):
        self.body, self.k = body, k
        self.state = tuple(torch.empty_like(t) for t in state)
        self.consts = tuple(torch.empty_like(t) for t in consts)
        self.flags = torch.zeros(k, dtype=torch.bool, device=state[0].device)
        self.graphs = {}

    def load(self, state, consts) -> None:
        for buf, t in zip(self.state + self.consts, state + consts):
            buf.copy_(t)

    def advance(self, n: int) -> torch.Tensor:
        cur, flags = self.state, []
        for _ in range(n):
            new = self.body(cur, self.consts)
            flags.append(_changed(new, cur))
            cur = new
        torch.stack(flags, out=self.flags[:n])
        for buf, t in zip(self.state, cur):
            buf.copy_(t)
        return self.flags[:n]

    def capture(self, pool) -> None:
        # a warm-up round on a side stream first, as torch.cuda.graphs
        # asks; the buffers are left as they were
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            _changed(self.body(self.state, self.consts), self.state)
        torch.cuda.current_stream().wait_stream(side)
        for n in dict.fromkeys((self.k, 1)):
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=pool,
                                  capture_error_mode="thread_local"):
                self.advance(n)
            self.graphs[n] = graph

    def replay(self, n: int) -> torch.Tensor:
        self.graphs[n].replay()
        return self.flags[:n]


def _replay_rounds(step, k: int, max_iters: int) -> tuple[int, int]:
    """The loop's exit rule over rounds run k at a time: ``step(n)``
    advances the loop n rounds (k, or 1 where fewer than k remain before
    ``max_iters``) and gives their change flags, read back in one host
    read. Returns (rounds, steps): rounds is the index of the first round
    that changed nothing, else ``max_iters``. The rounds that a step runs
    past that one leave the state as it was: a round is a deterministic
    function of the state, which that round did not change."""
    it = steps = 0
    while it < max_iters:
        n = k if max_iters - it >= k else 1
        flags = host_wait(torch.Tensor.tolist, step(n))  # host sync
        steps += 1
        for changed in flags:
            it += 1
            if not changed:
                return it, steps
    return it, steps


def _loop(body, state, consts, max_iters: int):
    """The loop one round at a time, each round's change test read back
    to the host. Returns (state, rounds)."""
    changed, it = True, 0
    while changed and it < max_iters:
        new = body(state, consts)
        changed = host_wait(bool, _changed(new, state))  # host sync
        state, it = new, it + 1
    return state, it


def _takes_kernel(t: torch.Tensor) -> bool:
    """Whether a min or reach round over ``t`` runs csrc/flood.cu: CUDA
    tensors; every other device takes the plain body."""
    return t.is_cuda


def _fixpoint(name: str, key, body, state, consts, max_iters: int):
    """Run ``body(state, consts) -> state`` (tuples of tensors) until a
    round changes nothing or for ``max_iters`` rounds, as the span
    ``name`` with its ``rounds``, ``replays`` (graph replays),
    ``captured`` (1 where this call captured its graphs) and ``kernel``
    (1 where the rounds ran csrc/flood.cu: a body marked ``kernel`` over
    a state that ``_takes_kernel``). Returns the final state.

    Where ``_takes_graphs`` (2D CUDA tensors), the loop replays the
    graphs of ``_Rounds`` for (``key``, k, the device, ``kernel``, each
    tensor's shape and dtype), captured on first use (outside any span,
    and never while a profiler records: until then such a call runs one
    round at a time), and returns clones of the graphs' state buffers,
    which the next call of the same key overwrites. Otherwise (CPU and 3D
    tensors) one round at a time (``_loop``)."""
    global captures, replays
    rounds, captured, reps = None, 0, 0
    kernel = int(getattr(body, "kernel", False) and _takes_kernel(state[0]))
    if _takes_graphs(state[0]):
        dev = state[0].device
        full = (key, _GRAPH_ROUNDS, dev, kernel,
                tuple((t.shape, t.dtype) for t in state + consts))
        rounds = _GRAPHS.get(full)
        if rounds is None and not _tap._is_profiler_enabled:
            with torch.cuda.device(dev):
                rounds = _Rounds(body, state, consts, _GRAPH_ROUNDS)
                pool = _POOLS.get(dev)
                if pool is None:
                    pool = _POOLS[dev] = torch.cuda.graph_pool_handle()
                rounds.capture(pool)
            _GRAPHS[full] = rounds
            captures += 1
            captured = 1
    with span(name) as sp:
        if rounds is None:
            state, it = _loop(body, state, consts, max_iters)
        else:
            rounds.load(state, consts)
            it, reps = _replay_rounds(rounds.replay, rounds.k, max_iters)
            replays += reps
            state = tuple(t.clone() for t in rounds.state)
        sp.set(rounds=it, replays=reps, captured=captured, kernel=kernel)
    return state


def flood_reach(seeds: torch.Tensor, mask: torch.Tensor,
                connectivity: int = 1, max_iters: int = 512,
                max_run: int | None = None) -> torch.Tensor:
    """Pixels of ``mask`` reachable from ``seeds`` through ``mask``.

    Inputs of >= 2^22 pixels first flood a coarse grid of fully-inside-mask
    4-blocks and add the reached blocks as seeds (exact: the fine loop still
    runs to its fixed point)."""
    c = 4
    if seeds.numel() >= (1 << 22) and all(s >= 4 * c for s in mask.shape):
        solid = _block_pool(mask, c, "all")
        cseeds = _block_pool(seeds & mask, c, "any") & solid
        creach = _flood_reach_flat(cseeds, solid, 1, max_iters, max_run)
        up = creach
        for ax, s in enumerate(mask.shape):
            idx = torch.arange(s, device=mask.device) // c
            up = torch.index_select(up, ax, idx)
        seeds = seeds | (up & mask)
    return _flood_reach_flat(seeds, mask, connectivity, max_iters, max_run)


def _on_kernel(plain, binding, connectivity: int, max_run: int | None):
    """A round body marked ``kernel``: ``binding`` (a csrc/flood.cu
    round over the state and the mask, ``consts[0]``) where
    ``_takes_kernel``, else the plain body."""
    def body(state, consts):
        (cur,), mask = state, consts[0]
        if _takes_kernel(cur):
            return (binding(cur.contiguous(), mask.contiguous(),
                            connectivity, max_run),)
        return plain(state, consts)

    body.kernel = True
    return body


def _reach_round(ndim: int, connectivity: int, max_run: int | None):
    """One round of ``flood_reach``: state (reach,), inputs (mask,);
    ``kernels.flood_reach`` on CUDA tensors."""
    return _on_kernel(_reach_round_plain(ndim, connectivity, max_run),
                      kernels.flood_reach, connectivity, max_run)


def _reach_round_plain(ndim: int, connectivity: int,
                       max_run: int | None):
    """One round of ``flood_reach`` in torch ops."""
    shifts = [s for s in _neighbor_shifts(ndim, connectivity)
              if sum(abs(o) for o in s) >= 2]

    def body(state, consts):
        (cur,), (mask,) = state, consts
        nb = cur
        for off in shifts:
            nb = nb | shifted(cur, off, False)
        cur = mask & (cur | nb)
        for axis in range(ndim):
            cur = _run_or_scan(cur, mask, axis, False, max_run)
            cur = _run_or_scan(cur, mask, axis, True, max_run)
        return (cur,)

    return body


def _flood_reach_flat(seeds: torch.Tensor, mask: torch.Tensor,
                      connectivity: int = 1, max_iters: int = 512,
                      max_run: int | None = None) -> torch.Tensor:
    (reach,) = _fixpoint(
        "flood.reach", ("reach", connectivity, max_run),
        _reach_round(mask.ndim, connectivity, max_run), (seeds & mask,),
        (mask,), max_iters)
    return reach


def _window_pool(x: torch.Tensor, reduce_fn, fill) -> torch.Tensor:
    """Exact reduce over the full 3^ndim neighborhood (separable)."""
    for ax in range(x.ndim):
        off_p = [0] * x.ndim
        off_p[ax] = 1
        off_m = [0] * x.ndim
        off_m[ax] = -1
        x = reduce_fn(reduce_fn(x, shifted(x, tuple(off_p), fill)),
                      shifted(x, tuple(off_m), fill))
    return x


def border_mask(shape, device=None) -> torch.Tensor:
    border = torch.zeros(tuple(shape), dtype=torch.bool, device=device)
    for ax in range(len(shape)):
        idx = [slice(None)] * len(shape)
        idx[ax] = 0
        border[tuple(idx)] = True
        idx[ax] = shape[ax] - 1
        border[tuple(idx)] = True
    return border


def _min_round(ndim: int, connectivity: int, max_run: int | None):
    """One round of ``_min_flood``: state (lbl,), inputs (mask, a tensor
    of _INF); ``kernels.flood_min`` on CUDA tensors."""
    return _on_kernel(_min_round_plain(ndim, connectivity, max_run),
                      kernels.flood_min, connectivity, max_run)


def _min_round_plain(ndim: int, connectivity: int, max_run: int | None):
    """One round of ``_min_flood`` in torch ops."""
    shifts = [s for s in _neighbor_shifts(ndim, connectivity)
              if sum(abs(o) for o in s) >= 2]
    full_conn = connectivity == ndim

    def body(state, consts):
        (cur,), (mask, inf) = state, consts
        if full_conn:
            cur = torch.where(mask,
                              _window_pool(cur, torch.minimum, _INF), inf)
        else:
            nb = cur
            for off in shifts:
                nb = torch.minimum(nb, shifted(cur, off, _INF))
            cur = torch.where(mask, torch.minimum(cur, nb), inf)
        for axis in range(ndim):
            cur = _run_min_scan(cur, mask, axis, False, max_run)
            cur = _run_min_scan(cur, mask, axis, True, max_run)
        return (cur,)

    return body


def _min_flood(init: torch.Tensor, mask: torch.Tensor, connectivity: int,
               max_iters: int, max_run: int | None,
               span_name: str = "flood.ccl") -> torch.Tensor:
    """Iterate neighbor-min + segmented min-scans to the fixed point (the
    shared body of label and segstats.rank_labels, whose runs are the
    spans ``flood.ccl`` and ``flood.rank``)."""
    (lbl,) = _fixpoint(
        span_name, ("min", connectivity, max_run),
        _min_round(mask.ndim, connectivity, max_run), (init,),
        (mask, torch.full_like(init, _INF)), max_iters)
    return lbl


def label(mask: torch.Tensor, connectivity: int | None = None,
          max_iters: int = 512, max_run: int | None = None) -> torch.Tensor:
    """Label connected components of a boolean mask (int32). Each id is 1 +
    the linear index of the component's minimum pixel."""
    if connectivity is None:
        connectivity = mask.ndim
    lin = (torch.arange(mask.numel(), dtype=torch.int32, device=mask.device)
           + 1).reshape(mask.shape)
    lbl0 = torch.where(mask, lin, torch.full_like(lin, _INF))
    lbl = _min_flood(lbl0, mask, connectivity, max_iters, max_run)
    return torch.where(mask, lbl, torch.zeros_like(lbl))


def _id_counts(labels: torch.Tensor):
    """(flat ids clipped to [0, numel], per-id pixel counts): the
    reference's scatter tables of labels.numel() + 1 entries."""
    size = labels.numel()
    flat = torch.clamp(labels.reshape(-1).to(torch.int64), 0, size)
    return flat, torch.bincount(flat, minlength=size + 1)


def relabel_sequential(labels: torch.Tensor):
    """Remap positive labels to 1..n keeping their order (skimage
    relabel_sequential). Returns (new_labels int32, n_labels int32)."""
    size = labels.numel()
    flat = labels.reshape(-1).to(torch.int64)
    flat_c = torch.clamp(flat, 0, size)
    presence = torch.zeros(size + 1, dtype=torch.int32, device=labels.device)
    presence[flat_c] = 1
    presence[0] = 0
    newid = torch.cumsum(presence, dim=0, dtype=torch.int32)
    out = newid[flat_c] * (flat > 0)
    return out.reshape(labels.shape), newid[-1]


def clear_border(labels: torch.Tensor) -> torch.Tensor:
    """Zero every component touching the image border (skimage
    clear_border)."""
    size = labels.numel()
    flat = torch.clamp(labels.reshape(-1).to(torch.int64), 0, size)
    border = border_mask(labels.shape, labels.device).reshape(-1)
    marked = torch.zeros(size + 1, dtype=torch.bool, device=labels.device)
    marked[flat[border]] = True
    marked[0] = False
    drop = marked[flat].reshape(labels.shape)
    return torch.where(drop, torch.zeros_like(labels), labels)


def remove_small_objects(mask: torch.Tensor, min_size: int,
                         connectivity: int | None = None) -> torch.Tensor:
    """Drop connected components smaller than ``min_size`` from a boolean
    mask (skimage remove_small_objects)."""
    flat, counts = _id_counts(label(mask, connectivity))
    return mask & (counts[flat] >= min_size).reshape(mask.shape)


def filter_and_relabel(labels: torch.Tensor, min_size: int,
                       drop_border: bool = True):
    """remove_small_labels + clear_border + relabel_sequential in one
    counts pass, one border pass, a cumsum and one gather. Returns
    (new_labels int32, n_labels int32)."""
    flat, counts = _id_counts(labels)
    keep = counts >= min_size
    if drop_border:
        border = border_mask(labels.shape, labels.device).reshape(-1)
        keep[flat[border]] = False
    keep[0] = False
    newid = torch.cumsum(keep.to(torch.int32), dim=0, dtype=torch.int32)
    value_tbl = torch.where(keep, newid, torch.zeros_like(newid))
    return value_tbl[flat].reshape(labels.shape), newid[-1]


def remove_small_labels(labels: torch.Tensor, min_size: int) -> torch.Tensor:
    """Zero label regions smaller than ``min_size``, keeping the remaining
    ids (skimage remove_small_objects on a label image)."""
    flat, counts = _id_counts(labels)
    keep = (counts[flat] >= min_size).reshape(labels.shape)
    return torch.where(keep, labels, torch.zeros_like(labels))
