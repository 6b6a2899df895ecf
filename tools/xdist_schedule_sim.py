"""Replay xdist's `--dist load` schedule and predict which tests a worker
crash at the memory-map limit kills.

Inputs, all from one whole run of the suite:
  --order     the collected node ids, `pytest --collect-only -q` (one per
              line; lines without `::` are ignored);
  --junit     its `--junitxml` file (each test's duration);
  --maps-log  its `tools/maps_log_plugin.py` log (each test's growth in
              memory maps on the worker that ran it).

The model follows xdist 3.x `LoadScheduling`: an initial chunk of
`N // workers // 4` consecutive items per worker, then a refill to
`pending // workers // 2` when a worker's queue falls below a quarter of
that; a crashed worker's queue goes back to the end of `pending` and a
fresh worker replaces it.  A worker crashes in the test whose growth
would take it past `--limit` maps.  Tests not in the log grow by
`--default-maps`.  To try another collected count, edit the order file
(drop or add lines) and run again; `--runs` with `--noise` jitters every
duration by a log-normal factor and counts the victims over the runs.

    python tools/xdist_schedule_sim.py --order order.txt --junit run.xml \\
        --maps-log maps.log --runs 200 --noise 0.15
"""
import argparse
import collections
import heapq
import random
import xml.etree.ElementTree as ET


def load(order_path, junit_path, maps_path):
    order = [ln.strip() for ln in open(order_path) if "::" in ln]
    dur = {}
    for tc in ET.parse(junit_path).getroot().iter("testcase"):
        nid = (tc.attrib["classname"].replace(".", "/") + ".py::"
               + tc.attrib["name"])
        dur[nid] = float(tc.attrib["time"])
    start, grow = {}, {}
    for ln in open(maps_path):
        parts = ln.split()
        if (len(parts) < 4 or parts[0] == "main"
                or parts[1] not in ("START", "END")):
            continue
        worker, kind, nid = parts[:3]
        maps = int(parts[3].split("=")[1])
        if kind == "START":
            start[(worker, nid)] = maps
        elif (worker, nid) in start:
            grow[nid] = maps - start[(worker, nid)]
    return order, dur, grow


def simulate(order, dur, grow, workers=6, limit=65530, base_maps=680,
             startup=12.0, default_maps=300, default_dur=1.0, noise=0.0,
             rng=None):
    """Return the node ids that were running when a worker crashed."""
    rng = rng or random.Random(0)
    d = [dur.get(x, default_dur)
         * (rng.lognormvariate(0, noise) if noise else 1.0) for x in order]
    g = [grow.get(x, default_maps) for x in order]
    pending = list(range(len(order)))
    nodes, victims, heap = {}, [], []

    def new_node(now):
        name = f"gw{len(nodes)}"
        nodes[name] = dict(q=[], maps=base_maps, ready=now + startup,
                           running=False, down=False)
        return name

    def send(name, num):
        nodes[name]["q"].extend(pending[:num])
        del pending[:num]

    def check(name, duration=0.0):
        if not pending:
            return
        alive = sum(not n["down"] for n in nodes.values())
        lo = max(2, len(pending) // alive // 4)
        hi = max(2, len(pending) // alive // 2)
        queued = len(nodes[name]["q"])
        if queued < lo and not (duration >= 0.1 and queued >= 2):
            send(name, hi - queued)

    def start_next(name, now):
        node = nodes[name]
        node["running"] = bool(node["q"]) and not node["down"]
        if node["running"]:
            i = node["q"][0]
            heapq.heappush(heap, (max(now, node["ready"]) + d[i], name, i))

    for _ in range(workers):
        new_node(0.0)
    for name in list(nodes):
        send(name, max(len(order) // workers // 4, 2))
        start_next(name, 0.0)
    while heap:
        now, name, i = heapq.heappop(heap)
        node = nodes[name]
        if node["maps"] + g[i] > limit:
            victims.append(order[i])
            node["down"], node["running"] = True, False
            pending.extend(node["q"][1:])
            node["q"] = []
            new_node(now)
            for other in nodes:
                if not nodes[other]["down"]:
                    check(other)
        else:
            node["maps"] += g[i]
            node["q"].pop(0)
            node["running"] = False
            check(name, d[i])
        for other in nodes:
            if not nodes[other]["running"]:
                start_next(other, now)
    return victims


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--order", required=True)
    ap.add_argument("--junit", required=True)
    ap.add_argument("--maps-log", required=True)
    ap.add_argument("--workers", type=int, default=6)
    ap.add_argument("--limit", type=int, default=65530)
    ap.add_argument("--runs", type=int, default=1)
    ap.add_argument("--noise", type=float, default=0.0)
    args = ap.parse_args()
    order, dur, grow = load(args.order, args.junit, args.maps_log)
    counts = collections.Counter()
    for r in range(args.runs):
        counts.update(simulate(order, dur, grow, workers=args.workers,
                               limit=args.limit, noise=args.noise,
                               rng=random.Random(r)))
    print(f"{len(order)} items, {args.runs} run(s), noise {args.noise}")
    for nid, n in counts.most_common(15):
        print(f"{n:5d}  {nid}")


if __name__ == "__main__":
    main()
