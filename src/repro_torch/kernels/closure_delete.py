"""Launch wrappers of kernels B3 and B5, one delete-repair hop
(`csrc/closure_delete.cu` with its two paths in `csrc/bitgemm.cuh`,
`csrc/closure_delete_tiled.cu`; they replace
the TPU kernels `repro/kernels/closure_delete.py::closure_delete` and
`::closure_delete_tiled`).

``closure_delete(r (M, C/32), s (C, C/32), affected (ceil(M/32),))`` ->
``affected[w] ? r[w] | OR_{x: r[w, x]} s[x] : r[w]`` in a new tensor (the
kernels must not write in place: other warps read r's rows as their lhs).
r is the whole closure (M = C) or one shard's row block of it
(`core/sharded.closure_delete_impl`), with ``affected`` that block's row
mask;
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


def _delete_shapes(name, c, w, s_shape, a_shape, work_shape=None):
    """r (M, W) is M rows of an s (32 W, W); affected holds a bit an r row
    (and work, for the main launch alone, an entry per 128 r rows)."""
    want_work = ((c + ROWS_PER_BLOCK - 1) // ROWS_PER_BLOCK,)
    if (s_shape != (w * 32, w) or a_shape != ((c + 31) // 32,)
            or work_shape not in (None, want_work)):
        work = "" if work_shape is None else ", work (ceil(M/128),)"
        got = "" if work_shape is None else f", {tuple(work_shape)}"
        raise ValueError(
            f"{name} shapes must be r (M, C/32), s (C, C/32), affected "
            f"(ceil(M/32),){work}; got {(c, w)}, {tuple(s_shape)}, "
            f"{tuple(a_shape)}{got}")


def closure_delete(r_packed: torch.Tensor, s_packed: torch.Tensor,
                   affected_packed: torch.Tensor) -> torch.Tensor:
    dev, ((c, w), s_shape, a_shape) = _build.check_operands(
        (r_packed, "r", 2, _build.INT32), (s_packed, "s", 2, _build.INT32),
        (affected_packed, "affected", 1, _build.INT32))
    _delete_shapes("closure_delete", c, w, s_shape, a_shape)
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
    _delete_shapes("closure_delete_paths", c, w, s_shape, a_shape, w_shape)
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
