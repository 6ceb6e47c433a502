"""Out-of-memory recovery (the port of hiprfish_tpu/utils/oom.py): retry a
computation down a ladder of smaller chunk or batch sizes.

PyTorch's caching allocator raises ``torch.OutOfMemoryError`` (which is
``torch.cuda.OutOfMemoryError``) at the allocation that does not fit, so
an out-of-memory failure surfaces where it happens, with no device sync.
``is_oom_error`` also keeps the JAX package's message patterns, so an
error that names an exhausted device by text counts as well. The port's
retry hook is ``empty_cache``: it hands the cached blocks of the failed
attempt back to the device before the next size runs.

Used by the streamed 3D measurement (pipeline/segment3d.py, the z_chunk
ladder) and the multi-card batch runner (parallel/fov_batch.py, the batch
halving).
"""

from __future__ import annotations

import logging
from typing import Callable, Iterable, Sequence

import torch

log = logging.getLogger("hiprfish_tpu_torch.oom")


def is_oom_error(e: BaseException) -> bool:
    """True for a device out-of-memory failure: ``torch.OutOfMemoryError``,
    or an error whose message says so in any of the reference's patterns
    (RESOURCE_EXHAUSTED, OOM, out of memory, would exceed memory, exceeded
    HBM capacity)."""
    if isinstance(e, torch.OutOfMemoryError):
        return True
    s = str(e)
    sl = s.lower()
    return ("RESOURCE_EXHAUSTED" in s or "ResourceExhausted" in s
            or "OOM" in s or "out of memory" in sl
            or "would exceed memory" in sl
            or "exceeded hbm capacity" in sl)


def empty_cache(size=None, nxt=None) -> None:
    """The port's ``on_retry`` hook: release the allocator's cached blocks
    (a no-op where CUDA was never initialised)."""
    torch.cuda.empty_cache()


def run_with_backoff(fn: Callable, sizes: Sequence,
                     label: str = "chunk", on_retry: Callable | None = None):
    """``fn(size)`` down a ladder of sizes until one fits on the device.

    Returns (result, size_used). Non-OOM exceptions propagate immediately;
    exhausting the ladder re-raises the last OOM. ``on_retry(size, next)``
    is called before each retry (hook for freeing caches)."""
    sizes = list(sizes)
    if not sizes:
        raise ValueError("empty size ladder")
    last = None
    for i, size in enumerate(sizes):
        try:
            return fn(size), size
        except Exception as e:  # noqa: BLE001 - filtered by is_oom_error
            if not is_oom_error(e):
                raise
            # without its traceback the error no longer holds the failed
            # attempt's frames, so their tensors free before the retry
            last = e.with_traceback(None)
        nxt = sizes[i + 1] if i + 1 < len(sizes) else None
        log.warning("device OOM at %s=%s%s", label, size,
                    f", retrying with {nxt}" if nxt is not None
                    else "; ladder exhausted")
        if nxt is not None and on_retry is not None:
            on_retry(size, nxt)
    raise last


def halving_ladder(start: int, floor: int = 1) -> Iterable[int]:
    """start, start//2, ... down to ``floor`` (inclusive when reached)."""
    out = []
    s = int(start)
    while s > floor:
        out.append(s)
        s //= 2
    out.append(max(s, floor))
    return out
