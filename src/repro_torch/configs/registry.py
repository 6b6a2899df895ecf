"""Architecture registry of the port: ``--arch <id>`` selection (the LM
and recsys parts of `repro.configs.registry`).  Holds the archs ported
so far; the reference's other LM configs and the GNNs wait for
ROADMAP.md section A item 12c."""
from __future__ import annotations

from typing import Dict, List

from repro_torch.configs import lm_common, qwen2_1_5b, xdeepfm

_LM = {m.ARCH_ID: m for m in (qwen2_1_5b,)}
_REC = {m.ARCH_ID: m for m in (xdeepfm,)}

ARCHS: Dict[str, str] = {**{k: "lm" for k in _LM},
                         **{k: "recsys" for k in _REC}}


def _family(arch: str) -> str:
    if arch not in ARCHS:
        raise ValueError(f"arch must be one of {sorted(ARCHS)} (the archs "
                         f"ported so far), got {arch!r}")
    return ARCHS[arch]


def shapes_for(arch: str) -> List[str]:
    if _family(arch) == "lm":
        return list(lm_common.LM_SHAPES)
    return list(_REC[arch].SHAPES)


def lm_config(arch: str):
    """The full-width `LMConfig` of LM arch ``arch``."""
    if arch not in _LM:
        raise ValueError(f"arch must be one of {sorted(_LM)} (the LM archs "
                         f"ported so far), got {arch!r}")
    return _LM[arch].CFG


def run_smoke(arch: str, device=None) -> dict:
    """The arch's reduced smoke run on ``device`` (None: the card).  The
    LM smoke run of the reference takes a training step, which waits for
    ROADMAP.md section A item 12c."""
    if _family(arch) == "lm":
        raise NotImplementedError(
            "the LM smoke run takes a training step: LM training is not "
            "ported yet (ROADMAP.md section A item 12c)")
    return _REC[arch].run_smoke(device)
