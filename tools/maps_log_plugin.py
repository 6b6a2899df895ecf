"""Pytest plugin: log each test's worker and the process's memory-map count.

XLA:CPU keeps a few memory maps per cached executable, and a worker that
reaches the kernel's `vm.max_map_count` dies inside a compile.  This log
shows which worker ran which test and how close it came.  Run the suite
as usual with the plugin loaded:

    MAPS_LOG=maps.log PYTHONPATH=src:tools python -m pytest -p maps_log_plugin -n 6 ...

Each line is `<worker> START|END <nodeid> maps=<count> t=<unix seconds>`
(`main` for the controlling process).  `tools/xdist_schedule_sim.py`
reads it.  Linux only (`/proc/self/maps`).
"""
import os
import time


def _maps():
    try:
        with open("/proc/self/maps") as f:
            return sum(1 for _ in f)
    except OSError:
        return -1


def _write(kind, nodeid=""):
    worker = os.environ.get("PYTEST_XDIST_WORKER", "main")
    with open(os.environ.get("MAPS_LOG", "maps.log"), "a") as f:
        f.write(f"{worker} {kind} {nodeid} maps={_maps()} "
                f"t={time.time():.3f}\n")


def pytest_runtest_logstart(nodeid, location):
    _write("START", nodeid)


def pytest_runtest_logfinish(nodeid, location):
    _write("END", nodeid)
