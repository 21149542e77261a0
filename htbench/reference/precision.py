"""The reference's precision: float32 throughout, or, for the control,
TF32 (the precision the configuration's float32 with TF32 off is one step
above): the inputs of every matrix product, einsum and convolution rounded
to TF32's 10-bit mantissa (to nearest, ties to even), sums in float32, as
the card's tensor cores compute them when TF32 is allowed. Emulated so that
it holds at every shape: at these small inner dimensions cuBLAS and cuDNN
pick float32 FMA kernels even with TF32 allowed. The rounding passes
gradients through unchanged."""

from __future__ import annotations

import contextlib

import torch

_STATE = {"tf32": False}


@contextlib.contextmanager
def tf32():
    """The reference computed in TF32 inside this block."""
    old = _STATE["tf32"]
    _STATE["tf32"] = True
    try:
        yield
    finally:
        _STATE["tf32"] = old


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    b = x.detach().float().contiguous().view(torch.int32)
    b = (b + 0x0FFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


def r(x: torch.Tensor) -> torch.Tensor:
    if not _STATE["tf32"] or not x.is_floating_point():
        return x
    return x + (round_tf32(x) - x).detach()


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return r(a) @ r(b)


def einsum(eq: str, *xs: torch.Tensor) -> torch.Tensor:
    return torch.einsum(eq, *(r(x) for x in xs))
