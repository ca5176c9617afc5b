"""Device selection and matmul precision for the port.

Every entry point runs on the card unless the caller asks for the CPU.  The
CPU runs the kernels' plain versions; it is never a fallback for a missing
card.
"""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``.  Raises if CUDA is asked for but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on an NVIDIA GPU by default. "
            "Pass device='cpu' to run the plain PyTorch versions of its "
            "kernels on the CPU."
        )
    return dev


@contextlib.contextmanager
def fp32_matmul():
    """Run float32 matmuls in full IEEE fp32 (no TF32) inside the block.

    The JAX reference computes these products in float32; TF32 keeps about
    three decimal digits, which moves argmax lags.  The global setting is
    restored on exit, so no caller relies on it.
    """
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)
