"""Launch wrapper of kernel B2, the rank-B closure fold
(`csrc/closure_update.cu`; replaces the TPU kernel
`repro/kernels/closure_update.py::closure_update`, dense variant).

``closure_update(closure (C, C/32), mask (C, B/32), rows (B, C/32))``
-> ``closure | OR_{j: mask[w, j]} rows[j]`` in a new (C, C/32) tensor, on
CUDA int32 words holding the uint32 bit pattern.  It launches the kernel
or raises; the plain version is `kernels/ref.closure_update_ref`."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def closure_update(closure_packed: torch.Tensor, mask_packed: torch.Tensor,
                   rows_packed: torch.Tensor) -> torch.Tensor:
    dev = closure_packed.device
    _build.check_operand(closure_packed, "closure", 2)
    _build.check_operand(mask_packed, "mask", 2, dev)
    _build.check_operand(rows_packed, "rows", 2, dev)
    c, w = closure_packed.shape
    c2, wb = mask_packed.shape
    b, w2 = rows_packed.shape
    if c2 != c or w2 != w or wb * 32 != b:
        raise ValueError(
            "closure_update shapes must be closure (C, W), mask (C, B/32), "
            f"rows (B, W); got {tuple(closure_packed.shape)}, "
            f"{tuple(mask_packed.shape)}, {tuple(rows_packed.shape)}")
    out = torch.empty_like(closure_packed)
    if out.numel():
        _build.launch("closure_update", "repro_closure_update", dev,
                      closure_packed, mask_packed, rows_packed, out, c, wb, w)
    return out
