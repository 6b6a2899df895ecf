"""Multi-tenant serving front-end over the writer/reader split (port of
`repro.serve`).

Concurrent client streams fill the engine's batch dimension B through an
asyncio coalescer (`frontend.Frontend`), with deficit-round-robin tenant
fairness on batch slots (`fairness.DeficitRoundRobin`), admission
control off the engine's ``n_overflow`` backpressure
(`admission.AdmissionController`), and open-loop p50/p99 latency
measurement (`openloop.run_openloop`).
"""
from repro_torch.serve.admission import (ADMISSION_POLICIES,
                                         AdmissionController, ReplicaHealth)
from repro_torch.serve.fairness import DeficitRoundRobin
from repro_torch.serve.frontend import (KINDS, READERS, STATUS_OK,
                                        STATUS_SHED, Frontend,
                                        FrontendClosed, FrontendConfig,
                                        Request, Response)
from repro_torch.serve.openloop import OpenLoopResult, run_openloop

__all__ = [
    "ADMISSION_POLICIES", "AdmissionController", "DeficitRoundRobin",
    "Frontend", "FrontendClosed", "FrontendConfig", "KINDS",
    "OpenLoopResult", "READERS", "ReplicaHealth", "Request", "Response",
    "STATUS_OK", "STATUS_SHED", "run_openloop",
]
