"""The fused multiply-add of the port's ``ops/fused.py`` (a frozen copy):
on the CPU ``a * b + c`` rounded once, as the JAX package's compiler
fuses it; on the card a multiply and an add.
"""

from __future__ import annotations

import torch


def mul_add(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` of float32 tensors where the reference's compiler
    fuses that sum into one multiply-add on the CPU, rounded once: a term
    of a triangle-weighted scan's ``acc + w * v``, a bilinear sample's
    weighted corners, an affine map's coordinates.

    On CPU tensors the port rounds it the same way: the product of two
    float32 values is exact in float64, so only the sum is rounded before
    the final rounding (which differs from one fused
    rounding only where the float64 sum falls on a float32 midpoint, about
    once in 2**29), and the tests hold the port bit for bit against the
    reference. On the card it is a multiply and an add, each rounded
    (within an ulp of the fused term), with no float64 temporaries: nothing
    there is compared bit for bit with the reference."""
    if a.device.type == "cpu":
        return (a.double() * b.double() + c.double()).float()
    return a * b + c


def recip(n) -> torch.Tensor:
    """``1 / n`` rounded to float32 (a 0-d CPU tensor): ``x * recip(n)``
    is the reference compiler's ``x / n`` for a constant ``n``."""
    return torch.tensor(1.0, dtype=torch.float32) / n
