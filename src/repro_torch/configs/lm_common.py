"""LM config plumbing shared by the LM archs (port of the smoke part of
`repro.configs.lm_common`)."""
from __future__ import annotations

import dataclasses

from repro_torch.models.transformer import LMConfig


def smoke_cfg(cfg: LMConfig) -> LMConfig:
    """Reduced same-family config for CPU smoke runs: 2 layers, d_model
    64, at most 4 heads, d_ff 128, vocab 512 (the reference's values)."""
    moe = cfg.moe
    if moe is not None:
        n_e = min(4, moe.n_experts)
        moe = dataclasses.replace(moe, n_experts=n_e,
                                  top_k=min(moe.top_k, n_e), d_ff=32)
    return dataclasses.replace(
        cfg, n_layers=2, d_model=64,
        n_heads=max(2, min(4, cfg.n_heads)),
        n_kv=2 if cfg.n_kv > 1 else 1, d_ff=128, vocab=512, moe=moe,
        q_chunk=32, kv_chunk=32)
