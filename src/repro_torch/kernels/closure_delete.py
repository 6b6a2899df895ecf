"""Launch wrappers of kernels B3 and B5, one delete-repair hop
(`csrc/closure_delete.cu`, `csrc/closure_delete_tiled.cu`; they replace
the TPU kernels `repro/kernels/closure_delete.py::closure_delete` and
`::closure_delete_tiled`).

``closure_delete(r (C, C/32), s (C, C/32), affected (C/32,))`` ->
``affected[w] ? r[w] | OR_{x: r[w, x]} s[x] : r[w]`` in a new tensor (the
kernels must not write in place: other warps read r's rows as their lhs);
``closure_delete_tiled`` computes the same on a tiles window (R, R/32)
and also returns ``occ`` (R/32, R/32), the output's per-32x32-tile
occupancy (0/1).  CUDA int32 words holding the uint32 bit pattern; each
launches its kernel or raises.  The plain versions are
`kernels/ref.closure_delete_ref` and `closure_delete_tiled_ref`."""
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


def closure_delete_tiled(r_packed: torch.Tensor, s_packed: torch.Tensor,
                         affected_packed: torch.Tensor):
    dev = r_packed.device
    _build.check_operand(r_packed, "r", 2)
    _build.check_operand(s_packed, "s", 2, dev)
    _build.check_operand(affected_packed, "affected", 1, dev)
    r, w = r_packed.shape
    if tuple(s_packed.shape) != (r, w) or w * 32 != r \
            or tuple(affected_packed.shape) != (w,):
        raise ValueError(
            "closure_delete_tiled shapes must be r (R, R/32), s (R, R/32), "
            f"affected (R/32,); got {tuple(r_packed.shape)}, "
            f"{tuple(s_packed.shape)}, {tuple(affected_packed.shape)}")
    out = torch.empty_like(r_packed)
    occ = torch.empty((r // 32, w), dtype=torch.int32, device=dev)
    if out.numel():
        _build.launch("closure_delete_tiled", "repro_closure_delete_tiled",
                      dev, r_packed, s_packed, affected_packed, out, occ, r, w)
    return out, occ
