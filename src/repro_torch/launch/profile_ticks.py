"""Where a serving tick's time goes on the card.

    python -m repro_torch.launch.profile_ticks --profile delheavy \\
        --capacity 16384 --batch 1024 --warm 8 --ticks 4
    python -m repro_torch.launch.profile_ticks --profile mixed \\
        --capacity 131072 --batch 128 --method incremental \\
        --closure-layout tiled

Replays ``--warm`` ticks of an SGT stream (`launch/serve.py`; method
"auto" and the dense closure unless ``--method`` / ``--closure-layout``
say otherwise), then runs ``--ticks`` more twice from the same engine
(engines are immutable, so both runs do the same work): once timed with
no profiler, for the wall time per tick, and once under `torch.profiler`
(CPU and CUDA activities), for the device time.  Prints one JSON line:
wall and device-busy milliseconds per tick, the device's idle share, the
host-side launches and copies per tick, and the device kernels that take
the most time.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.core.dispatch import METHODS
from repro_torch.core.engine import DagEngine, resolve_device
from repro_torch.launch import serve


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def profile_ticks(profile_name: str, capacity: int, batch: int, warm: int,
                  ticks: int, device=None, method: str = "auto",
                  closure_layout: str = "dense") -> dict:
    dev = resolve_device(device)
    if profile_name == "steady":
        tick, inputs = serve.steady_tick, serve._sgt_tick_inputs(
            capacity, batch, warm + ticks, 0)
    elif profile_name == "insheavy":
        tick, inputs = serve.insert_heavy_tick, serve._sgt_insert_heavy_inputs(
            capacity, batch, warm + ticks, 0)
    else:
        tick, inputs = serve.churn_tick, serve._sgt_churn_inputs(
            capacity, batch, warm + ticks, 0, profile_name)
    eng0 = DagEngine.create(capacity, method=method,
                            closure_layout=closure_layout, device=dev)
    for xs in inputs[:warm]:
        eng0, _ = tick(eng0, serve.on_device(dev, xs))
    serve._sync(dev)

    def run():
        eng = eng0
        for xs in inputs[warm:]:
            eng, _ = tick(eng, serve.on_device(dev, xs))
        serve._sync(dev)

    t0 = time.perf_counter()
    run()
    wall_ms = (time.perf_counter() - t0) * 1e3 / ticks
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    events = prof.key_averages()
    # device-side events (kernels, copies, sets) only: host operators
    # carry the device time of their kernels too, and would count it twice
    on_device = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_ms = sum(_device_us(e) for e in on_device) / 1e3 / ticks
    launches = sum(e.count for e in events if e.key == "cudaLaunchKernel")
    copies = sum(e.count for e in events
                 if e.key in ("cudaMemcpyAsync", "cudaMemcpy"))
    top = sorted(on_device, key=lambda e: -_device_us(e))[:12]
    return {"profile": profile_name, "capacity": capacity, "batch": batch,
            "method": method, "closure_layout": closure_layout,
            "ticks": ticks, "wall_ms_per_tick": wall_ms,
            "device_busy_ms_per_tick": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "kernel_launches_per_tick": launches / ticks,
            "memcpy_per_tick": copies / ticks,
            "top_device_kernels": [
                {"name": e.key[:90], "ms_per_tick": _device_us(e) / 1e3 / ticks,
                 "calls_per_tick": e.count / ticks} for e in top]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--profile", default="delheavy",
                   choices=serve.PROFILES)
    p.add_argument("--capacity", type=int, default=16384)
    p.add_argument("--batch", type=int, default=1024)
    p.add_argument("--warm", type=int, default=8)
    p.add_argument("--ticks", type=int, default=4)
    p.add_argument("--device", default="cuda")
    p.add_argument("--method", default="auto", choices=METHODS)
    p.add_argument("--closure-layout", default="dense",
                   choices=("dense", "tiled"))
    args = p.parse_args(argv)
    print(json.dumps(profile_ticks(args.profile, args.capacity, args.batch,
                                   args.warm, args.ticks, args.device,
                                   args.method, args.closure_layout)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
