"""Wrappers, plain versions and the build of the hand-written CUDA kernels."""

from __future__ import annotations

import torch

# dtypes of the finalize step and of the sparse kernels K9-K12
KERNEL_DTYPES = (torch.float32, torch.float64)
# dtypes of K1-K4: bf16 is storage, computed in float32 with float32 scalars
# and partials (config.scalar_dtype)
STENCIL_DTYPES = (*KERNEL_DTYPES, torch.bfloat16)


def check_tensors(ref: torch.Tensor, dtypes=KERNEL_DTYPES, **tensors) -> None:
    """Raise unless ``ref``'s dtype is one of ``dtypes`` and every named
    ``(tensor, shape, dtype)`` (None: absent / any shape / ref's dtype) is on
    ref's device, of that dtype and shape, and contiguous: what a kernel
    takes."""
    if ref.dtype not in dtypes:
        names = "/".join(str(d).replace("torch.", "") for d in dtypes)
        raise TypeError(f"the kernel takes {names}, got {ref.dtype}")
    for name, (t, shape, dtype) in tensors.items():
        if t is None:
            continue
        dtype = ref.dtype if dtype is None else dtype
        if t.device != ref.device:
            raise ValueError(f"{name} is on {t.device}, expected {ref.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
        if shape is not None and tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
