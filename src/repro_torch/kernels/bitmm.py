"""Launch wrapper of kernel B1, the packed boolean product
(`csrc/bitmm.cu`; replaces the TPU kernel `repro/kernels/bitmm.py::bitmm`).

``bitmm(lhs (M, K/32), rhs (K, N/32)) -> (M, N/32)`` on CUDA int32 words
holding the uint32 bit pattern: out[m] = OR over set bits j of lhs[m] of
rhs[j].  It launches the kernel or raises; the plain version is
`kernels/ref.bitmm_ref`, and `kernels/ops.bitmm_packed` chooses."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def bitmm(lhs_packed: torch.Tensor, rhs_packed: torch.Tensor) -> torch.Tensor:
    _build.check_operand(lhs_packed, "lhs", 2)
    _build.check_operand(rhs_packed, "rhs", 2, lhs_packed.device)
    m, wk = lhs_packed.shape
    k, wn = rhs_packed.shape
    if wk * 32 != k:
        raise ValueError(f"lhs has {wk} words per row, so rhs needs "
                         f"{wk * 32} rows, got {tuple(rhs_packed.shape)}")
    out = torch.empty((m, wn), dtype=torch.int32, device=lhs_packed.device)
    if out.numel():
        _build.launch("bitmm", "repro_bitmm", lhs_packed.device,
                      lhs_packed, rhs_packed, out, m, wk, wn)
    return out
