"""Attention for the LM, in torch (port of the serving half of
`repro.models.attention`).

- Prefill attention is `kernels.ops.flash_attention` (kernel B7 on CUDA
  tensors, its plain version on CPU tensors), called by
  `models.transformer`.
- ``decode_attention``: one-token attention against the KV cache, in
  plain torch (the reference has no kernel there either).

The reference's ``flash_chunked`` and its custom-vjp backward are its
training and non-TPU prefill path; they wait for the training slice
(ROADMAP.md section A item 12).

Tensor layout at this interface: q/k/v are (B, T, H, Dh).
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len,
                     scale: float | None = None) -> torch.Tensor:
    """One-token attention: q (B, 1, Hq, d), caches (B, S, Hkv, d), in
    float32.  ``cache_len`` (an int, or a scalar or (B,) tensor) masks the
    valid prefix: key positions ``< cache_len``."""
    b, s, hkv, d = k_cache.shape
    hq = q.shape[2]
    g = hq // hkv
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    qg = q.reshape(b, hkv, g, d).to(torch.float32)
    kf = k_cache.to(torch.float32)
    vf = v_cache.to(torch.float32)
    sc = torch.einsum("bhgd,bshd->bhgs", qg, kf) * scale
    pos = torch.arange(s, device=q.device)[None, :]
    if isinstance(cache_len, torch.Tensor):
        cache_len = cache_len.to(q.device).reshape(-1, 1)
    valid = pos < cache_len                        # (B, S) or (1, S)
    sc = torch.where(valid[:, None, None, :], sc, NEG_INF)
    m = sc.amax(dim=-1, keepdim=True)
    p = torch.exp(sc - m)
    den = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgs,bshd->bhgd", p / den, vf)
    return out.reshape(b, 1, hq, d).to(q.dtype)
