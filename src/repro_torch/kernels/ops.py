"""Public wrappers over the hand-written kernels, with device dispatch.

``impl`` selects the execution path:
  "auto"  the CUDA kernel for CUDA tensors, the plain torch version for
          CPU tensors (decided by where the operands lie, nothing else)
  "cuda"  the CUDA kernel; raises for operands that are not on a card
  "ref"   the plain torch version (`kernels/ref.py`)

There is no fallback: a kernel that fails to build or launch raises.
`LAUNCHES` counts launches per kernel (``LAUNCHES["bitmm"]`` ...);
`reset_launches` zeroes it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import bitmm as _bitmm
from repro_torch.kernels import closure_delete as _closure_delete
from repro_torch.kernels import closure_update as _closure_update
from repro_torch.kernels import embbag as _embbag
from repro_torch.kernels import flash_attention as _flash_attention
from repro_torch.kernels import ref as _ref
from repro_torch.kernels._build import LAUNCHES, reset_launches  # noqa: F401

IMPLS = ("auto", "cuda", "ref")


def _resolve(impl: str, operand: torch.Tensor) -> str:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "auto":
        return "cuda" if operand.is_cuda else "ref"
    return impl


def bitmm_packed(lhs_packed, rhs_packed, *, impl: str = "auto"):
    """Boolean matmul over packed words (reachability hot spot):
    (M, K/32) x (K, N/32) -> (M, N/32)."""
    if _resolve(impl, lhs_packed) == "ref":
        return _ref.bitmm_ref(lhs_packed, rhs_packed)
    return _bitmm.bitmm(lhs_packed, rhs_packed)


def closure_update(closure_packed, mask_packed, rows_packed, *,
                   impl: str = "auto"):
    """Rank-B transitive-closure update (incremental-cache hot spot):
    out[w] = closure[w] | OR_{j: mask[w, j]} rows[j]."""
    if _resolve(impl, closure_packed) == "ref":
        return _ref.closure_update_ref(closure_packed, mask_packed,
                                       rows_packed)
    return _closure_update.closure_update(closure_packed, mask_packed,
                                          rows_packed)


def closure_delete(r_packed, s_packed, affected_packed, *,
                   impl: str = "auto"):
    """Delete-repair hop (delta-commit delete hot spot):
    out[w] = affected[w] ? r[w] | OR_{x: r[w, x]} s[x] : r[w] — the
    per-hop product of `closure_cache.masked_delete_scan`."""
    if _resolve(impl, r_packed) == "ref":
        return _ref.closure_delete_ref(r_packed, s_packed, affected_packed)
    return _closure_delete.closure_delete(r_packed, s_packed,
                                          affected_packed)


def closure_update_tiled(tiles_packed, mask_packed, rows_packed, *,
                         impl: str = "auto"):
    """Rank-B fold on a tiled closure's region window, plus the output's
    per-32x32-tile occupancy: -> (tiles' (R, R/32), occ (R/32, R/32) 0/1;
    pack occ into the summary with `closure_cache.summary_from_occ`)."""
    if _resolve(impl, tiles_packed) == "ref":
        return _ref.closure_update_tiled_ref(tiles_packed, mask_packed,
                                             rows_packed)
    return _closure_update.closure_update_tiled(tiles_packed, mask_packed,
                                                rows_packed)


def closure_delete_tiled(r_packed, s_packed, affected_packed, *,
                         impl: str = "auto"):
    """Delete-repair hop on a tiled closure's region window, plus the
    output's per-32x32-tile occupancy: -> (r' (R, R/32), occ (R/32, R/32)
    0/1) — the tiled layout's hop of `closure_cache.masked_delete_scan`."""
    if _resolve(impl, r_packed) == "ref":
        return _ref.closure_delete_tiled_ref(r_packed, s_packed,
                                             affected_packed)
    return _closure_delete.closure_delete_tiled(r_packed, s_packed,
                                                affected_packed)


def flash_attention(q, k, v, *, causal: bool = True, scale=None,
                    impl: str = "auto"):
    """GQA flash attention, forward (the LM prefill's attention):
    q (B, Hq, Tq, d), k and v (B, Hkv, Tk, d) -> (B, Hq, Tq, d) in q's
    type; causal aligned to the end of the key sequence."""
    if _resolve(impl, q) == "ref":
        return _ref.flash_attention_ref(q, k, v, causal=causal, scale=scale)
    return _flash_attention.flash_attention(q, k, v, causal=causal,
                                            scale=scale)


def embedding_bag(table, idx, weights, *, impl: str = "auto"):
    """Weighted embedding bag (the recsys lookup): table (R, D), idx and
    weights (B, K) -> (B, D) in the table's type, out[b] = sum_k
    w[b, k] * table[idx[b, k]] in float32; weight 0 marks padding."""
    if _resolve(impl, table) == "ref":
        return _ref.embbag_ref(table, idx, weights)
    return _embbag.embbag(table, idx, weights)
