"""The precision the plain reference computes in.

``FLOAT32`` is the precision the configurations state: float32 images,
spectra and classifier arithmetic, with TF32 off in every matrix product.
``BFLOAT16`` is the correctness control, the nearest precision below it:
every float32 stage result is rounded to bfloat16 and the classifier's
matrix products take bfloat16 operands. The control is never timed; it
stands in the program's place to show that the comparison fails it.
"""

from __future__ import annotations

import torch


class Precision:
    def __init__(self, name: str, low: torch.dtype | None):
        self.name = name
        self._low = low

    def round(self, x: torch.Tensor) -> torch.Tensor:
        """x as this precision holds it (float32 comes back float32)."""
        if self._low is None or not x.is_floating_point():
            return x
        return x.to(self._low).to(x.dtype)

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a @ b in float32, from operands in this precision."""
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if self._low is None:
            return a.to(torch.float32) @ b.to(torch.float32)
        return (a.to(self._low) @ b.to(self._low)).to(torch.float32)


FLOAT32 = Precision("float32", None)
BFLOAT16 = Precision("bfloat16", torch.bfloat16)
BY_NAME = {p.name: p for p in (FLOAT32, BFLOAT16)}
