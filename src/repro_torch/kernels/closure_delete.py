"""Launch wrappers of kernels B3 and B5, one delete-repair hop
(`csrc/closure_delete.cu` with its two paths in `csrc/bitgemm.cuh`,
`csrc/closure_delete_tiled.cu`; they replace
the TPU kernels `repro/kernels/closure_delete.py::closure_delete` and
`::closure_delete_tiled`).

``closure_delete(r (C, C/32), s (C, C/32), affected (C/32,))`` ->
``affected[w] ? r[w] | OR_{x: r[w, x]} s[x] : r[w]`` in a new tensor (the
kernels must not write in place: other warps read r's rows as their lhs);
``closure_delete_tiled`` computes the same on a tiles window (R, R/32)
and also returns ``occ`` (R/32, R/32), the output's per-32x32-tile
occupancy (0/1).  CUDA int32 words holding the uint32 bit pattern; each
launches its kernel or raises.  A B3 call is two launches, as B1's
(`kernels/bitmm.py`): a count of each 128-row block's set bits in its
affected rows, then the hop, each block on the path its count picks.
The plain versions are `kernels/ref.closure_delete_ref` and
`closure_delete_tiled_ref`."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.bitmm import ROWS_PER_BLOCK


def closure_delete(r_packed: torch.Tensor, s_packed: torch.Tensor,
                   affected_packed: torch.Tensor) -> torch.Tensor:
    dev, ((c, w), s_shape, a_shape) = _build.check_operands(
        (r_packed, "r", 2, _build.INT32), (s_packed, "s", 2, _build.INT32),
        (affected_packed, "affected", 1, _build.INT32))
    if s_shape != (c, w) or w * 32 != c or a_shape != (w,):
        raise ValueError(
            "closure_delete shapes must be r (C, C/32), s (C, C/32), "
            f"affected (C/32,); got {(c, w)}, {tuple(s_shape)}, "
            f"{tuple(a_shape)}")
    out = torch.empty_like(r_packed)
    if c:
        blocks = (c + ROWS_PER_BLOCK - 1) // ROWS_PER_BLOCK
        work = r_packed.new_empty((blocks,))
        _build.launch("closure_delete", "repro_closure_delete", dev,
                      r_packed.data_ptr(), s_packed.data_ptr(),
                      affected_packed.data_ptr(), out.data_ptr(),
                      work.data_ptr(), c, w)
    return out


def closure_delete_paths(r_packed: torch.Tensor, s_packed: torch.Tensor,
                         affected_packed: torch.Tensor,
                         work: torch.Tensor) -> torch.Tensor:
    """B3's main launch alone on ``work`` (int32, one entry per 128 rows),
    as `kernels.bitmm.bitmm_paths`: for timing or checking one path."""
    dev, ((c, w), s_shape, a_shape, w_shape) = _build.check_operands(
        (r_packed, "r", 2, _build.INT32), (s_packed, "s", 2, _build.INT32),
        (affected_packed, "affected", 1, _build.INT32),
        (work, "work", 1, _build.INT32))
    if (s_shape != (c, w) or w * 32 != c or a_shape != (w,)
            or w_shape != ((c + ROWS_PER_BLOCK - 1) // ROWS_PER_BLOCK,)):
        raise ValueError(
            "closure_delete_paths shapes must be r (C, C/32), s (C, C/32), "
            f"affected (C/32,), work (ceil(C/128),); got {(c, w)}, "
            f"{tuple(s_shape)}, {tuple(a_shape)}, {tuple(w_shape)}")
    out = torch.empty_like(r_packed)
    if c:
        _build.launch("closure_delete", "repro_closure_delete_paths", dev,
                      r_packed.data_ptr(), s_packed.data_ptr(),
                      affected_packed.data_ptr(), out.data_ptr(),
                      work.data_ptr(), c, w)
    return out


def closure_delete_tiled(r_packed: torch.Tensor, s_packed: torch.Tensor,
                         affected_packed: torch.Tensor):
    dev, ((r, w), s_shape, a_shape) = _build.check_operands(
        (r_packed, "r", 2, _build.INT32), (s_packed, "s", 2, _build.INT32),
        (affected_packed, "affected", 1, _build.INT32))
    if s_shape != (r, w) or w * 32 != r or a_shape != (w,):
        raise ValueError(
            "closure_delete_tiled shapes must be r (R, R/32), s (R, R/32), "
            f"affected (R/32,); got {(r, w)}, {tuple(s_shape)}, "
            f"{tuple(a_shape)}")
    out, occ = torch.empty_like(r_packed), r_packed.new_empty((w, w))
    if r:
        _build.launch("closure_delete_tiled", "repro_closure_delete_tiled",
                      dev, r_packed.data_ptr(), s_packed.data_ptr(),
                      affected_packed.data_ptr(), out.data_ptr(),
                      occ.data_ptr(), r, w)
    return out, occ
