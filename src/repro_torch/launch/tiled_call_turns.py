"""Kernels B4 and B5 of two source trees, timed turn for turn on one card.

    python src/repro_torch/launch/tiled_call_turns.py \\
        --tree before=path/to/other/src --tree after=src

runs one process per tree in the order before, after, after, before, each
with that tree's ``src`` first on ``PYTHONPATH``, so each process builds
and calls its own tree's wrappers (``repro_torch.kernels.ops``).  A process
makes the tiled main path's operands from a seed (R=1024, B=128, 1%
dense; B5 with 1% and 25% of rows affected), checks each kernel against
its plain version bit for bit, and times it as ``chip_smoke.py`` phase 3
does: TURNS rounds of kernel, library, library, kernel (CUDA events, a
mean over ``reps`` calls a turn; the library yardstick is one fp16
``torch.matmul`` of the unpacked operands), the kernel's device time
alone (``torch.profiler``) and the host's wall time a call of calls
issued without a sync.  Each process prints one JSON line; the parent
prints them all and, last, each tree's two values of each time, sorted.
The file imports only what both trees have, so it runs against a tree
that lacks it.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

R, B, DENSITY, TURNS, REPS = 1024, 128, 0.01, 5, 1000


def _cuda_ms(fn, reps: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _host_ms(fn, reps: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return ms


def _device_ms(fn, reps: int, kernel: str) -> float:
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if f"{kernel}_kernel" in e.key]
    us = sum(getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0)) for e in events)
    return us / 1e3 / max(1, sum(e.count for e in events))


def one_tree(label: str) -> dict:
    """Times of this process's tree (whichever ``repro_torch`` imports)."""
    import numpy as np
    import torch
    from repro_torch.core import bitset
    from repro_torch.kernels import ops

    gen = torch.Generator(device="cuda").manual_seed(0)

    def packed(shape, density):
        return bitset.pack_bits(torch.rand(shape, generator=gen,
                                           device="cuda") < density)

    tiles, s = packed((R, R), DENSITY), packed((R, R), DENSITY)
    mask, rows = packed((R, B), DENSITY), packed((B, R), DENSITY)
    cases = {"closure_update_tiled": (ops.closure_update_tiled,
                                      (tiles, mask, rows), (mask, rows))}
    for frac in (0.01, 0.25):
        cases[f"closure_delete_tiled {frac:.0%} affected"] = (
            ops.closure_delete_tiled, (tiles, s, packed((R,), frac)),
            (tiles, s))
    out = {"tree": label, "src": os.environ.get("PYTHONPATH", "")}
    for name, (op, args, lib_args) in cases.items():
        got, want = op(*args, impl="cuda"), op(*args, impl="ref")
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise SystemExit(f"{label}: {name} disagrees with its plain "
                             "version")
        a, b = (bitset.unpack_bits(x).to(torch.float16) for x in lib_args)

        def kernel():
            return op(*args, impl="cuda")

        def library():
            return torch.matmul(a, b)

        k_turns, l_turns = [], []
        for _ in range(TURNS):
            k_turns.append(_cuda_ms(kernel, REPS))
            l_turns += [_cuda_ms(library, REPS), _cuda_ms(library, REPS)]
            k_turns.append(_cuda_ms(kernel, REPS))
        out[name] = {
            "kernel_ms": float(np.median(k_turns)),
            "library_ms": float(np.median(l_turns)),
            "won": sum(k < lt for k, lt in zip(k_turns, l_turns)),
            "of": len(k_turns),
            "device_ms": _device_ms(kernel, 200, name.split()[0]),
            "host_ms": _host_ms(kernel, REPS),
            "library_host_ms": _host_ms(library, REPS)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", action="append", default=[],
                    metavar="LABEL=SRC", help="a tree's label and its src "
                    "directory; two trees run in the order A, B, B, A")
    ap.add_argument("--one", metavar="LABEL",
                    help="time this process's tree only (used by the "
                    "parent process)")
    args = ap.parse_args(argv)
    if args.one:
        print(json.dumps(one_tree(args.one)), flush=True)
        return 0
    trees = [t.split("=", 1) for t in args.tree]
    if len(trees) != 2:
        ap.error("give two --tree LABEL=SRC")
    results = []
    for label, src in trees + trees[::-1]:
        env = dict(os.environ, PYTHONPATH=os.path.abspath(src))
        line = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one", label],
            env=env, check=True, stdout=subprocess.PIPE,
            text=True).stdout.strip().splitlines()[-1]
        print(line, flush=True)
        results.append(json.loads(line))
    summary = {}
    for label, _ in trees:
        mine = [r for r in results if r["tree"] == label]
        summary[label] = {
            name: {k: sorted(r[name][k] for r in mine)
                   for k in ("kernel_ms", "library_ms", "device_ms",
                             "host_ms")}
            for name in mine[0] if name not in ("tree", "src")}
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
