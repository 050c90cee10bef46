"""Device and dtype resolution shared by every entry point.

The port runs on a CUDA card unless the caller asks for the CPU: an
entry point given ``device=None`` resolves to ``cuda`` and RAISES when
no GPU is present -- it never carries on quietly on the CPU, where the
hand-written kernels do not run and every timing would mean something
else.  The default compute dtype is float32 on CUDA (the kernels'
type) and float64 on the CPU (the float64 reference path).
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA request without a GPU raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain PyTorch path on the CPU")
        # Every float32 product here must be full float32: the check
        # contract (mse < 1e-8) is lost to TF32's ~1e-3 relative
        # rounding (reduced-precision products cost 18x in check mse on
        # the reference implementation).  Both switches are process
        # wide; the port only ever turns them off.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev


def default_dtype(device: torch.device) -> torch.dtype:
    """float32 on CUDA (the kernels' type), float64 on the CPU."""
    return torch.float32 if device.type == "cuda" else torch.float64


def as_torch_dtype(dtype) -> torch.dtype | None:
    """Accept torch dtypes, numpy dtypes and their names."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    name = np.dtype(dtype).name
    return {"float32": torch.float32, "float64": torch.float64}[name]


def host64(t: torch.Tensor) -> np.ndarray:
    """A tensor as a float64 numpy array on the host."""
    return t.detach().to("cpu", torch.float64).numpy()
