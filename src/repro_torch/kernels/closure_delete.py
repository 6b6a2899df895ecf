"""Launch wrapper of kernel B3, one delete-repair hop
(`csrc/closure_delete.cu`; replaces the TPU kernel
`repro/kernels/closure_delete.py::closure_delete`, dense variant).

``closure_delete(r (C, C/32), s (C, C/32), affected (C/32,))`` ->
``affected[w] ? r[w] | OR_{x: r[w, x]} s[x] : r[w]`` in a new tensor (the
kernel must not write in place: other warps read r's rows as their lhs).
CUDA int32 words holding the uint32 bit pattern; it launches or raises.
The plain version is `kernels/ref.closure_delete_ref`."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def closure_delete(r_packed: torch.Tensor, s_packed: torch.Tensor,
                   affected_packed: torch.Tensor) -> torch.Tensor:
    dev = r_packed.device
    _build.check_operand(r_packed, "r", 2)
    _build.check_operand(s_packed, "s", 2, dev)
    _build.check_operand(affected_packed, "affected", 1, dev)
    c, w = r_packed.shape
    if tuple(s_packed.shape) != (c, w) or w * 32 != c \
            or tuple(affected_packed.shape) != (w,):
        raise ValueError(
            "closure_delete shapes must be r (C, C/32), s (C, C/32), "
            f"affected (C/32,); got {tuple(r_packed.shape)}, "
            f"{tuple(s_packed.shape)}, {tuple(affected_packed.shape)}")
    out = torch.empty_like(r_packed)
    if out.numel():
        _build.launch("closure_delete", "repro_closure_delete", dev,
                      r_packed, s_packed, affected_packed, out, c, w)
    return out
