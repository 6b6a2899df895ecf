"""Durability and fault injection for the port: atomic engine checkpoints
(`checkpoint`) and seeded fault plans (`faults`)."""
from repro_torch.ft.checkpoint import (  # noqa: F401
    CheckpointManager, CorruptCheckpointError, save_checkpoint,
    restore_checkpoint, all_steps, latest_step,
    save_engine_checkpoint, restore_engine_checkpoint,
)
from repro_torch.ft.faults import (  # noqa: F401
    Fault, FaultPlan, FaultSpec, InjectedCrash, NAMED_PLANS,
)
