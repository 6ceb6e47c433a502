"""The fixpoint floods' driver (``labeling._fixpoint``) run k rounds at a
time from CUDA graphs against the loop that runs one round at a time.

On the CPU (tier 1): the k-round step (``labeling._Rounds.advance``, the
function the graphs record, here run eagerly) and the exit rule over its
flags (``labeling._replay_rounds``) give the state and the round count of
the one-round loop (``labeling._loop``) for every flood body, every k and
caps that bind before, inside and after a step; and a CPU tensor or a 3D
one never captures a graph.

On the card (marked ``cuda``, skipped without one): ``flood_reach``,
``label``, ``segstats.rank_labels`` and ``watershed`` from graphs against
the same calls with the graphs turned off (bitwise outputs, equal
``rounds`` in their spans), on masks of 7-bit and 10-bit confluent and
sparse FOVs (``utils/synthetic.make_fov``), random masks and a serpentine
channel of > 40 rounds, at connectivity 1 and 2, with caps that bind
inside a replay, and with one key called twice in a row; and
``flood_reach``, ``label`` and ``rank_labels`` with their rounds on the
kernels of csrc/flood.cu against the plain rounds (bitwise outputs, equal
``rounds``, ``kernel`` 1 and 0), in 2D from graphs and in 3D one round at
a time.

    python -m pytest --noconftest tests/test_torch_flood_graphs.py -m cuda
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from hiprfish_tpu_torch.config import SEVEN_BIT, TEN_BIT
from hiprfish_tpu_torch.ops import labeling as lab
from hiprfish_tpu_torch.ops import segstats
from hiprfish_tpu_torch.ops import watershed as ws
from hiprfish_tpu_torch.utils import logging as ulog
from hiprfish_tpu_torch.utils import synthetic

torch.set_num_threads(1)

FLOODS = ("reach", "ccl", "rank", "watershed")


def serpentine(corridors: int, width: int) -> torch.Tensor:
    """One channel winding down ``corridors`` rows of ``width`` - 2 px, 4
    rows apart, joined at alternate ends, entered from the left border at
    (1, 0) and touching it nowhere else, with a dot (a component of its
    own) every other pixel of the row between two corridors: a flood
    crosses about one corridor a round, and the rank of the channel waits
    behind the dots' ranks."""
    m = torch.zeros((4 * corridors + 1, width), dtype=torch.bool)
    m[1, 0] = True
    for i in range(corridors):
        m[4 * i + 1, 1:width - 1] = True
        if i + 1 < corridors:
            col = width - 2 if i % 2 == 0 else 1
            m[4 * i + 1:4 * i + 6, col] = True
            m[4 * i + 3, 3:width - 3:2] = True
    return m


def cpu_case(flood: str, mask: torch.Tensor, conn: int = 1):
    """(body, state, consts) of one flood over ``mask``, built as the
    flood's function builds them."""
    if flood == "reach":
        seeds = lab.border_mask(mask.shape)
        return (lab._reach_round(mask.ndim, conn, None), (seeds & mask,),
                (mask,))
    inf = torch.full(mask.shape, lab._INF, dtype=torch.int32)
    if flood == "ccl":
        lin = (torch.arange(mask.numel(), dtype=torch.int32) + 1) \
            .reshape(mask.shape)
        return (lab._min_round(mask.ndim, conn, None),
                (torch.where(mask, lin, inf),), (mask, inf))
    if flood == "rank":
        labels = lab.label(mask, conn)
        lin = (torch.arange(mask.numel(), dtype=torch.int32) + 1) \
            .reshape(mask.shape)
        ranks = torch.cumsum((mask & (labels == lin)).reshape(-1)
                             .to(torch.int32), 0, dtype=torch.int32)
        return (lab._min_round(mask.ndim, conn, None),
                (torch.where(mask, ranks.reshape(mask.shape), inf),),
                (mask, inf))
    markers = torch.zeros(mask.shape, dtype=torch.int32)
    markers[1, 0] = 1
    surf = torch.zeros(mask.shape)
    seeded = (markers > 0) & mask
    zeros = torch.zeros_like(markers)
    big = torch.full_like(surf, ws._BIG)
    return (ws._watershed_round(lab._neighbor_shifts(mask.ndim, conn)),
            (torch.where(seeded, markers, zeros),
             torch.where(seeded, surf, big)),
            (surf, mask, markers, seeded, zeros, big))


def expected_steps(rounds: int, k: int, max_iters: int) -> int:
    """Host reads of ``_replay_rounds``: k-round steps while k rounds
    remain before the cap, then one-round steps."""
    whole = (max_iters // k) * k
    if rounds <= whole:
        return -(-rounds // k)
    return max_iters // k + rounds - whole


@pytest.mark.parametrize("flood", FLOODS)
@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("max_iters", [1, 2, 3, 4, 5, 9, 512])
def test_k_round_steps_keep_the_loop(flood, k, max_iters):
    """The serpentine takes 20-ish rounds (the watershed, which moves a
    pixel a round, ~90), so 1-9 bind before its fixed point and 512
    after it."""
    mask = serpentine(20, 16) if flood != "watershed" else serpentine(6, 12)
    body, state, consts = cpu_case(flood, mask)
    want, want_rounds = lab._loop(body, state, consts, max_iters)
    rounds = lab._Rounds(body, state, consts, k)
    rounds.load(state, consts)
    got_rounds, steps = lab._replay_rounds(rounds.advance, k, max_iters)
    assert got_rounds == want_rounds
    assert steps == expected_steps(want_rounds, k, max_iters)
    for a, b in zip(rounds.state, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    if max_iters == 512:
        assert 9 < want_rounds < 512
    else:
        assert want_rounds == max_iters


def flood_spans(fn):
    """(fn's output, [(span name, attrs)] of its flood spans), the spans
    recorded under a CPU profiler."""
    ulog.RECORDER.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            out = fn()
        return out, [(r["name"], r["attrs"]) for r in ulog.RECORDER.snapshot()
                     if r["name"].startswith("flood.")]
    finally:
        ulog.RECORDER.reset()


def flood_call(flood: str, mask: torch.Tensor, conn: int, max_iters: int,
               max_run=None):
    """The public call of one flood over ``mask`` (on its device): the
    reach from the border, the watershed from each component's first
    pixel."""
    if flood == "reach":
        border = lab.border_mask(mask.shape, mask.device)
        return lambda: lab.flood_reach(border, mask, conn, max_iters,
                                       max_run)
    if flood == "ccl":
        return lambda: lab.label(mask, conn, max_iters, max_run)
    labels = lab.label(mask, conn)
    if flood == "rank":
        return lambda: segstats.rank_labels(labels, conn, max_iters, max_run)
    gen = torch.Generator().manual_seed(mask.numel())
    surf = torch.rand(mask.shape, generator=gen).to(mask.device)
    lin = (torch.arange(mask.numel(), dtype=torch.int32, device=mask.device)
           + 1).reshape(mask.shape)
    # one marker a component, on its first pixel
    markers = torch.where(labels == lin, labels, torch.zeros_like(labels))
    return lambda: ws.watershed(surf, markers, mask, conn, max_iters)


@pytest.mark.parametrize("flood", FLOODS)
def test_cpu_and_3d_tensors_keep_the_loop(flood):
    """CPU tensors, 2D or 3D, run one round at a time: no capture, no
    replay, ``replays``, ``captured`` and ``kernel`` 0 in every flood
    span."""
    before = (lab.captures, lab.replays, len(lab._GRAPHS))
    for mask in (serpentine(6, 12), serpentine(6, 12)[:24].reshape(2, 12,
                                                                     12)):
        _, spans = flood_spans(flood_call(flood, mask, 1, 512))
        assert spans and all(a["replays"] == 0 and a["captured"] == 0
                             and a["kernel"] == 0 and a["rounds"] >= 1
                             for _, a in spans)
    assert (lab.captures, lab.replays, len(lab._GRAPHS)) == before


# ---------------------------------------------------------------- the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda", 0)


SIDE = 384


def fov_mask(kind: str) -> torch.Tensor:
    """The cell cores of a SIDE^2 FOV: pixels whose four neighbours carry
    their own truth label (touching cells come apart)."""
    if kind == "confluent7b":
        fov = synthetic.make_fov(SEVEN_BIT, [1 + i % 127 for i in range(110)],
                                 shape=(SIDE, SIDE), seed=3,
                                 cell_axes=synthetic.FLAGSHIP_CELL_AXES,
                                 spacing=27)
    elif kind == "confluent10b":
        fov = synthetic.make_fov(TEN_BIT,
                                 [(i * 37) % 1023 + 1 for i in range(85)],
                                 shape=(SIDE, SIDE), seed=4,
                                 cell_axes=synthetic.ECOLI_CELL_AXES,
                                 spacing=31)
    else:
        fov = synthetic.make_fov(SEVEN_BIT, [1 + i % 127 for i in range(36)],
                                 shape=(SIDE, SIDE), seed=5,
                                 cell_axes=synthetic.FLAGSHIP_CELL_AXES)
    t = torch.from_numpy(fov["truth_labels"])
    core = t > 0
    for off in ((0, 1), (0, -1), (1, 0), (-1, 0)):
        core &= lab.shifted(t, off, 0) == t
    return core


FOVS = ("confluent7b", "confluent10b", "sparse7b")


def card_mask(kind: str, flood: str = "ccl") -> torch.Tensor:
    """The mask of one card case; a FOV's reach floods the complement of
    its cores from the border, as fill-holes does."""
    if kind.startswith("random"):
        gen = torch.Generator().manual_seed(7)
        return torch.rand((SIDE, SIDE), generator=gen) < float(kind[6:])
    if kind == "serpentine":
        return serpentine(44, 24)
    return ~fov_mask(kind) if flood == "reach" else fov_mask(kind)


def graphs_and_loop(fn, monkeypatch):
    """((output, spans) from graphs, (output, spans) one round at a
    time): the graphs' call once unrecorded first, so that its keys are
    captured before the recorded one."""
    fn()
    graphs = flood_spans(fn)
    with monkeypatch.context() as mp:
        mp.setattr(lab, "_takes_graphs", lambda t: False)
        loop = flood_spans(fn)
    return graphs, loop


def assert_same(a, b):
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)


def assert_graphs_kept_the_loop(graphs, loop, k, max_iters):
    (out_g, spans_g), (out_l, spans_l) = graphs, loop
    assert_same(out_g, out_l)
    assert [n for n, _ in spans_g] == [n for n, _ in spans_l]
    for (_, g), (_, e) in zip(spans_g, spans_l):
        assert g["rounds"] == e["rounds"]
        assert g["replays"] == expected_steps(g["rounds"], k, max_iters)
        assert g["captured"] == 0 and e["replays"] == e["captured"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("flood", FLOODS)
@pytest.mark.parametrize("conn", [1, 2])
@pytest.mark.parametrize("kind", FOVS + ("random0.3", "random0.5",
                                          "random0.7", "serpentine"))
def test_graphs_give_the_loops_output_and_rounds(cuda, monkeypatch, flood,
                                                 conn, kind):
    fn = flood_call(flood, card_mask(kind, flood).to(cuda), conn, 2048,
                    16 if kind == "serpentine" else None)
    replays = lab.replays
    graphs, loop = graphs_and_loop(fn, monkeypatch)
    assert_graphs_kept_the_loop(graphs, loop, lab._GRAPH_ROUNDS, 2048)
    assert lab.replays > replays
    if kind == "serpentine":
        assert loop[1][-1][1]["rounds"] > 40


@pytest.mark.cuda
@pytest.mark.parametrize("flood", FLOODS)
@pytest.mark.parametrize("max_iters", [1, 3, 5, 7])
def test_a_cap_inside_a_replay_binds_where_the_loop_stops(
        cuda, monkeypatch, flood, max_iters):
    monkeypatch.setattr(lab, "_GRAPH_ROUNDS", 4)
    fn = flood_call(flood, serpentine(44, 24).to(cuda), 1, max_iters)
    graphs, loop = graphs_and_loop(fn, monkeypatch)
    assert_graphs_kept_the_loop(graphs, loop, 4, max_iters)
    assert loop[1][-1][1]["rounds"] == max_iters


@pytest.mark.cuda
@pytest.mark.parametrize("flood", FLOODS)
def test_one_key_twice_in_a_row_keeps_the_first_output(cuda, monkeypatch,
                                                       flood):
    """The second call of a key overwrites the graphs' state buffers; the
    first call's output is a copy of them."""
    first = flood_call(flood, card_mask("random0.5", flood).to(cuda), 2,
                       512)
    second = flood_call(flood, card_mask("confluent7b", flood).to(cuda), 2,
                        512)
    a = first()
    b = second()
    with monkeypatch.context() as mp:
        mp.setattr(lab, "_takes_graphs", lambda t: False)
        want_a, want_b = first(), second()
    assert_same(a, want_a)
    assert_same(b, want_b)


@pytest.mark.cuda
@pytest.mark.parametrize("flood", FLOODS)
def test_3d_cuda_tensors_keep_the_loop(cuda, flood):
    mask = serpentine(6, 12)[:24].reshape(2, 12, 12).to(cuda)
    before = (lab.captures, lab.replays)
    out, spans = flood_spans(flood_call(flood, mask, 1, 512))
    assert spans and all(a["replays"] == 0 for _, a in spans)
    assert (lab.captures, lab.replays) == before
    want, _ = flood_spans(flood_call(flood, mask.cpu(), 1, 512))
    assert_same(tuple(t.cpu() for t in (out if isinstance(out, tuple)
                                        else (out,))),
                want if isinstance(want, tuple) else (want,))


def kernel_and_plain(fn, monkeypatch):
    """((output, spans) with the rounds on csrc/flood.cu, (output, spans)
    with the plain rounds on the same card), each call once unrecorded
    first so that its graphs are captured."""
    fn()
    kernel = flood_spans(fn)
    with monkeypatch.context() as mp:
        mp.setattr(lab, "_takes_kernel", lambda t: False)
        fn()
        plain = flood_spans(fn)
    return kernel, plain


def assert_kernel_kept_the_plain_rounds(kernel, plain, graphs: bool):
    (out_k, spans_k), (out_p, spans_p) = kernel, plain
    assert_same(out_k, out_p)
    assert spans_k and [n for n, _ in spans_k] == [n for n, _ in spans_p]
    for (_, k), (_, p) in zip(spans_k, spans_p):
        assert k["rounds"] == p["rounds"] >= 1
        assert (k["replays"] >= 1) if graphs else (k["replays"] == 0)
        assert k["kernel"] == 1 and p["kernel"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("flood", ("reach", "ccl", "rank"))
@pytest.mark.parametrize("conn,max_run", [(1, None), (2, None), (1, 16),
                                          (2, 16), (1, 64), (2, 128)])
@pytest.mark.parametrize("kind", FOVS + ("random0.5", "random0.7",
                                          "serpentine"))
def test_kernel_rounds_keep_the_plain_floods_2d(cuda, monkeypatch, flood,
                                                conn, max_run, kind):
    fn = flood_call(flood, card_mask(kind, flood).to(cuda), conn, 2048,
                    max_run)
    assert_kernel_kept_the_plain_rounds(*kernel_and_plain(fn, monkeypatch),
                                        graphs=True)


@pytest.mark.cuda
@pytest.mark.parametrize("flood", ("reach", "ccl", "rank"))
@pytest.mark.parametrize("conn", [1, 2, 3])
@pytest.mark.parametrize("max_run", [None, 8, 32, 128])
@pytest.mark.parametrize("shape,density", [((24, 40, 150), 0.6),
                                           ((9, 170, 301), 0.75),
                                           ((130, 7, 66), 0.5)])
def test_kernel_rounds_keep_the_plain_floods_3d(cuda, monkeypatch, flood,
                                                conn, max_run, shape,
                                                density):
    gen = torch.Generator().manual_seed(sum(shape) + conn)
    mask = (torch.rand(shape, generator=gen) < density).to(cuda)
    fn = flood_call(flood, mask, conn, 512, max_run)
    assert_kernel_kept_the_plain_rounds(*kernel_and_plain(fn, monkeypatch),
                                        graphs=False)
