"""The port's fault injection (`repro_torch.ft.faults`) and chaos run
(`repro_torch.launch.serve.serve_chaos`) against the reference's, on the
CPU.

  * Every named plan, and a plan with every arm armed, makes the same
    draws as the reference's `FaultPlan` on the same call sequence: the
    same `injected` list, the same perturbed shipments and the same file
    bytes after a torn write or a bit flip.  Pure numpy: no XLA program.
  * `serve_chaos` at `tests/test_chaos.py`'s size (C=128, B=16, 10 ticks,
    2 replicas) on `kitchen-sink` at seed 11 returns what the reference's
    `repro.launch.serve.serve_chaos` returns on the same arguments: every
    counter, the epoch and ``disk_recovered``.  The reference runs once,
    in a module-scoped fixture (its replicas replay eagerly: ~220 XLA
    compilations, whose memory maps `jax.clear_caches()` frees when the
    module starts and ends).  The other named plans run through the
    port alone, which must answer right and converge under each.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
import jax  # noqa: E402

from repro.ft import faults as jfaults  # noqa: E402
from repro.launch.serve import serve_chaos as ref_serve_chaos  # noqa: E402
from repro.replica import LogEntry as JEntry  # noqa: E402
from repro.core.closure_cache import CacheDelta as JDelta  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.ft import checkpoint as tckpt  # noqa: E402
from repro_torch.ft import faults as tfaults  # noqa: E402
from repro_torch.launch.serve import serve_chaos  # noqa: E402

ALL_ARMS = dict(torn_write=0.5, bit_flip_file=0.5, bit_flip_ckpt=0.5,
                bit_flip_entry=0.5, drop_entry=0.5, dup_entry=0.5,
                reorder=0.5, stall=0.5, crash_flush=0.5, stall_s=0.0)

CHAOS = dict(capacity=128, batch=16, ticks=10, fault_seed=11, replicas=2,
             seed=11)


@pytest.fixture(scope="module", autouse=True)
def _fresh_xla_caches():
    # the executables cached before and during this module hold memory
    # maps; free them so this worker stays far from the kernel's limit
    jax.clear_caches()
    yield
    jax.clear_caches()


@pytest.fixture(scope="module")
def ref_kitchen_sink(tmp_path_factory):
    """The reference's chaos run on `kitchen-sink`, seed 11."""
    return ref_serve_chaos(fault_plan="kitchen-sink",
                           workdir=str(tmp_path_factory.mktemp("ref")),
                           **CHAOS)


def _entries(n):
    rng = np.random.default_rng(5)
    out = []
    for i in range(n):
        delta = {"add_u": rng.integers(0, 64, 4).astype(np.int32),
                 "add_v": rng.integers(0, 64, 4).astype(np.int32),
                 "add_mask": rng.random(4) < 0.5,
                 "rem_u": np.zeros(0, np.int32),
                 "rem_v": np.zeros(0, np.int32),
                 "rem_mask": np.zeros(0, bool),
                 "clear_slots": np.arange(i % 3, dtype=np.int32),
                 "clear_mask": np.ones(i % 3, bool)}
        out.append({"epoch": i + 1, "grow_to": 0, "prev_epoch": i,
                    "crc": 0, "delta": delta})
    return out


def _visit(plan, make_entry, tmp, tag):
    """One fixed sequence of call-site visits; returns what it changed."""
    seen = []
    log = tmp / f"{tag}.log"
    ckpt_dir = tmp / f"{tag}_ckpt"
    tckpt.save_checkpoint(str(ckpt_dir), 3, {"a": np.arange(64)})
    for rnd in range(4):
        log.write_bytes(bytes(range(256)) * 4)
        plan.corrupt_log_file(str(log))
        seen.append(log.read_bytes())
        plan.corrupt_checkpoint(str(ckpt_dir))
        seen.append((ckpt_dir / "step_00000003" / "arrays.npz").read_bytes())
        entries = [make_entry(e) for e in _entries(3 + rnd)]
        ship, faults = plan.perturb_entries(entries, site=f"ship{rnd}")
        seen.append([(int(e.epoch), [np.asarray(x).tobytes()
                                     for x in e.delta]) for e in ship])
        seen.append([tuple(f) for f in faults])
        seen.append(plan.maybe_stall(site=f"stall{rnd}"))
        seen.append(plan.crash_index(rnd + 1, site=f"flush{rnd}"))
    return seen, [tuple(f) for f in plan.injected]


def _port_entry(e):
    return interop.log_entry_from_arrays(e)


def _ref_entry(e):
    return JEntry(e["epoch"], e["grow_to"], JDelta(**e["delta"]),
                  e["prev_epoch"], e["crc"])


def test_plans_inject_like_the_reference(tmp_path):
    specs = {name: (tfaults.NAMED_PLANS[name], jfaults.NAMED_PLANS[name])
             for name in jfaults.NAMED_PLANS}
    specs["all-arms"] = (tfaults.FaultSpec(**ALL_ARMS),
                         jfaults.FaultSpec(**ALL_ARMS))
    assert set(tfaults.NAMED_PLANS) == set(jfaults.NAMED_PLANS)
    for name, (tspec, jspec) in specs.items():
        assert tspec == tspec.__class__(**jspec.__dict__)
        for seed in (0, 11):
            # the same paths, so the sites' names agree
            got_t = _visit(tfaults.FaultPlan(seed, tspec), _port_entry,
                           tmp_path, f"{name}{seed}")
            got_j = _visit(jfaults.FaultPlan(seed, jspec), _ref_entry,
                           tmp_path, f"{name}{seed}")
            assert got_t == got_j, (name, seed)
            if name == "kitchen-sink":
                assert got_t[1], "the plan fired nothing"


def test_plan_lookup_and_spec_validation():
    for name in tfaults.NAMED_PLANS:
        assert tfaults.plan(3, name).spec == tfaults.NAMED_PLANS[name]
    for bad in ({"torn_write": 1.5}, {"stall_s": -1.0}):
        with pytest.raises(ValueError) as t_err:
            tfaults.FaultSpec(**bad)
        with pytest.raises(ValueError) as j_err:
            jfaults.FaultSpec(**bad)
        assert str(t_err.value) == str(j_err.value)
    with pytest.raises(ValueError) as t_err:
        tfaults.plan(0, "kitchen-snk")
    with pytest.raises(ValueError) as j_err:
        jfaults.plan(0, "kitchen-snk")
    assert str(t_err.value) == str(j_err.value)
    assert "nearest valid fault plan is 'kitchen-sink'" in str(t_err.value)


def test_chaos_counters_match_the_reference(ref_kitchen_sink, tmp_path):
    for name in tfaults.NAMED_PLANS:
        out = serve_chaos(fault_plan=name, workdir=str(tmp_path / name),
                          device="cpu", **CHAOS)
        assert out["wrong_answers"] == 0 and out["converged"] == 1, name
        if name == "kitchen-sink":
            assert out == ref_kitchen_sink
