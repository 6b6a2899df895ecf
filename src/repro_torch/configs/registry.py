"""Architecture registry of the port: ``--arch <id>`` selection (the LM
part of `repro.configs.registry`).  Holds the LM archs ported so far;
the reference's other LM configs, the GNNs and recsys wait for ROADMAP.md
section A item 12."""
from __future__ import annotations

from repro_torch.configs import qwen2_1_5b

_LM = {m.ARCH_ID: m for m in (qwen2_1_5b,)}


def lm_config(arch: str):
    """The full-width `LMConfig` of LM arch ``arch``."""
    if arch not in _LM:
        raise ValueError(f"arch must be one of {sorted(_LM)} (the LM archs "
                         f"ported so far), got {arch!r}")
    return _LM[arch].CFG
