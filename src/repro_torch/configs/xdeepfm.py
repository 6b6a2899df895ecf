"""xdeepfm [recsys] n_sparse=39 embed_dim=10 cin_layers=200-200-200
mlp=400-400 interaction=cin [arXiv:1803.05170; paper].  The port's copy
of `repro.configs.xdeepfm`: the config, its shapes, the forward FLOP
count and the smoke run.  The reference's JAX lowering (`build_bundle`,
partition specs) belongs to its dry-run launcher and is not ported
(ROADMAP.md section A item 13).

Criteo-like power-law field vocabularies (~33M total rows, matching the
Criteo-Kaggle scale).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.engine import resolve_device
from repro_torch.models.recsys import xdeepfm as X

ARCH_ID = "xdeepfm"
FAMILY = "recsys"

CFG = X.XDeepFMConfig(
    name=ARCH_ID, n_fields=39, embed_dim=10, cin_layers=(200, 200, 200),
    mlp_dims=(400, 400),
    vocab_sizes=X.default_vocab_sizes(39, total=33_000_000),
    n_items=1_000_000, retrieval_dim=64)

SHAPES = {
    "train_batch": dict(kind="train", batch=65536),
    "serve_p99": dict(kind="serve", batch=512),
    "serve_bulk": dict(kind="serve", batch=262144),
    "retrieval_cand": dict(kind="retrieval", batch=1,
                           n_candidates=1_000_000),
}


def _fwd_flops(cfg: X.XDeepFMConfig, batch: int) -> float:
    f, d = cfg.n_fields, cfg.embed_dim
    cin = 0.0
    h_prev = f
    for h in cfg.cin_layers:
        cin += 2.0 * batch * h * h_prev * f * d
        h_prev = h
    dims = [f * d, *cfg.mlp_dims, 1]
    dnn = sum(2.0 * batch * dims[i] * dims[i + 1]
              for i in range(len(dims) - 1))
    return cin + dnn


def smoke_cfg() -> X.XDeepFMConfig:
    """The reference's reduced config of `run_smoke`."""
    return dataclasses.replace(
        CFG, n_fields=6, embed_dim=8, cin_layers=(16, 16), mlp_dims=(32,),
        vocab_sizes=(16, 32, 8, 64, 16, 8), n_items=256, retrieval_dim=16)


def run_smoke(device=None) -> dict:
    """The reduced config's loss and retrieval scores on ``device``
    (None: the card), from params seeded with 0; -> {"loss": float}."""
    dev = resolve_device(device)
    cfg = smoke_cfg()
    params = X.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(np.stack([rng.integers(0, v, 8)
                                     for v in cfg.vocab_sizes], 1)
                           .astype(np.int32)).to(dev)
    batch = {"ids": ids,
             "labels": torch.from_numpy(rng.integers(0, 2, 8)).to(dev)}
    loss = X.loss(cfg, params, batch)
    if not bool(torch.isfinite(loss)):
        raise RuntimeError(f"xdeepfm smoke: non-finite loss {loss}")
    s = X.retrieval_score(cfg, params, ids[:1],
                          torch.arange(256, device=dev))
    if not bool(torch.isfinite(s).all()):
        raise RuntimeError("xdeepfm smoke: non-finite retrieval scores")
    return {"loss": float(loss)}
