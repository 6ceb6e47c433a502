"""Frozen copy of hiprfish_tpu_torch/ops/fp.py for the benchmark's
plain reference, cut to what the reference calls; it imports nothing of
the port.

float32 arithmetic in the order the reference's compiled CPU program
uses, so that the plain versions give its bits on the CPU, and the one
place where the CPU and the card sum differently (``segment_sum``).

XLA's CPU backend contracts a multiply feeding an add into one fused
multiply-add, sums a reduction over a minor axis in runs of 32, rewrites a
cumulative sum into runs of 16 plus a scan of the runs' totals,
evaluates exp by a polynomial of its own and runs with denormals flushed
to zero. The functions here do
the same with plain torch operations on any device (denormal results of
``fma`` and ``exp`` become 0; no process-wide flag is set), so a plain
version takes one path on the CPU and on the card.
"""

from __future__ import annotations

import numpy as np
import torch

# the smallest normal float32; smaller magnitudes are flushed to 0
TINY = float(np.finfo(np.float32).tiny)
# rows quantised at once by fixed_point_sums: 2^18 rows of 63 channels
# make 132 MB float64 and int64 copies
FIXED_POINT_CHUNK = 1 << 18


def _f64(v):
    return v.to(torch.float64) if isinstance(v, torch.Tensor) else float(v)


def flush(x: torch.Tensor) -> torch.Tensor:
    """x with its denormal values (|x| below the smallest normal float32)
    replaced by zeros of the same sign."""
    return x * (x.abs() >= TINY)


def fma(a, b, c) -> torch.Tensor:
    """float32 a * b + c rounded once, as a fused multiply-add, denormal
    results flushed: the product of two float32 values is exact in
    float64, so only the float64 sum rounds before the float32 cast (a
    double rounding that differs from a true FMA only on exact float32
    midpoints). Python numbers stand for float32 constants."""
    return flush((_f64(a) * _f64(b) + _f64(c)).to(torch.float32))


def _scan(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sums along the last axis, added in sequence."""
    out = x.clone()
    for i in range(1, x.shape[-1]):
        out[..., i] += out[..., i - 1]
    return out


def cumsum_in_order(x: torch.Tensor, dim: int, base: int = 16):
    """Inclusive cumulative sum along ``dim``: in sequence up to ``base``
    entries; beyond, zero-padded runs of ``base`` scanned in sequence,
    plus the exclusive prefix of the runs' totals (itself computed so)."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    if n <= base:
        return _scan(x).movedim(-1, dim)
    m = -(-n // base)
    runs = torch.nn.functional.pad(x, (0, m * base - n)).reshape(
        *x.shape[:-1], m, base)
    local = _scan(runs)
    prefix = cumsum_in_order(local[..., -1], -1, base)
    excl = torch.cat([torch.zeros_like(prefix[..., :1]), prefix[..., :-1]],
                     dim=-1)
    out = (local + excl[..., None]).reshape(*x.shape[:-1], m * base)
    return out[..., :n].movedim(-1, dim)


# the reference CPU program's exp: log2(e), ln(2) in two parts and the
# polynomial's coefficients, all float32 values
_LOG2E = float(np.float32(1.4426950216293335))
_LN2_HI = float(np.float32(-0.693359375))
_LN2_LO = float(np.float32(0.00021219444170128554))
_EXP_POLY = tuple(float(np.float32(c)) for c in (
    0.00019875691214110702, 0.001398199936375022, 0.008333452045917511,
    0.04166579619050026, 0.1666666567325592, 0.5))


def exp(x: torch.Tensor) -> torch.Tensor:
    """float32 exp by the reference CPU program's polynomial: clamp to
    [-87.8, 88.8], n = floor(x log2(e) + 1/2) clamped to [-127, 127],
    r = x - n ln(2) in two parts, a degree-5 polynomial in r, times 2^n
    (2^-127 is 0); results below the smallest normal float32 are 0, as
    that program runs with denormals flushed."""
    x = torch.clamp(x.to(torch.float32), -87.8, 88.8)
    n = torch.clamp(torch.floor(fma(x, _LOG2E, 0.5)), -127.0, 127.0)
    r = fma(_LN2_HI, n, x)
    r = fma(_LN2_LO, n, r)
    p = fma(r, _EXP_POLY[0], _EXP_POLY[1])
    for c in _EXP_POLY[2:]:
        p = fma(p, r, c)
    p = fma(p, r * r, r) + 1.0
    scale = ((n.to(torch.int32) + 127) << 23).view(torch.float32)
    return flush(p * scale)


def fixed_point_sums(values: torch.Tensor, ids: torch.Tensor,
                     num_segments: int, span=None, offset=None,
                     bits: int | None = None):
    """((num_segments,) counts, (num_segments, K) sums) in float32 of the
    (N, K) ``values`` by (N,) ``ids``, the same bits for any order of the
    rows. Each value's offset from ``offset`` (0 by default) is rounded to
    an int64 multiple of span / 2^bits, the integers are summed (exact in
    any order, atomics included), and each sum count * offset + total *
    span / 2^bits is rounded once to float32; before that rounding it is
    within count * span * 2^-(bits+1) of the exact sum. ``span`` defaults
    to each column's largest magnitude and ``bits`` to 62 - bit_length(N),
    which keeps every total below 2^62. Ids outside [0, num_segments) add
    nothing. The rows are quantised FIXED_POINT_CHUNK at a time, so only a
    chunk's float64 and int64 copies exist at once."""
    n, k = values.shape
    dev = values.device
    if bits is None:
        bits = 62 - max(n, 1).bit_length()
    if span is None:
        span = torch.maximum(torch.amax(values, 0).abs(),
                             torch.amin(values, 0).abs())
    span = torch.as_tensor(span, device=dev).to(torch.float64)
    scale = torch.where(span > 0, 2.0 ** bits / span, torch.ones_like(span))
    off = (torch.zeros((), dtype=torch.float64, device=dev) if offset is None
           else torch.as_tensor(offset, device=dev).to(torch.float64))
    # out-of-range ids add to a spare row that is dropped
    ids = torch.where((ids >= 0) & (ids < num_segments), ids,
                      num_segments).to(torch.int64)
    total = torch.zeros((num_segments + 1, k), dtype=torch.int64, device=dev)
    step = FIXED_POINT_CHUNK
    for lo in range(0, n, step):
        q = torch.round((values[lo:lo + step].to(torch.float64) - off)
                        * scale).to(torch.int64)
        total.index_add_(0, ids[lo:lo + step], q)
    counts = torch.bincount(ids, minlength=num_segments + 1)[:num_segments]
    counts = counts.to(torch.float64)
    sums = counts[:, None] * off + total[:num_segments].to(torch.float64) \
        / scale
    return counts.to(torch.float32), sums.to(torch.float32)


def segment_sum(values: torch.Tensor, ids: torch.Tensor, num_segments: int,
                **fixed_point):
    """((num_segments,) counts, (num_segments, K) sums) in float32 of the
    (N, K) ``values`` by (N,) ``ids`` (ids outside [0, num_segments)
    dropped). On the CPU both are float32 sums in row order, as the
    reference's. On the card, where float32 atomics add in another order
    in every run, they are ``fixed_point_sums`` (with ``fixed_point`` as
    its span, offset and bits), so two runs give the same bits."""
    if values.device.type != "cpu":
        return fixed_point_sums(values, ids, num_segments, **fixed_point)
    keep = torch.nonzero((ids >= 0) & (ids < num_segments)).squeeze(1)
    v = values.to(torch.float32)[keep]
    cs = torch.zeros((num_segments, 1 + v.shape[1]), dtype=torch.float32)
    cs.index_add_(0, ids[keep].to(torch.int64),
                  torch.cat([torch.ones_like(v[:, :1]), v], dim=1))
    return cs[:, 0], cs[:, 1:]
