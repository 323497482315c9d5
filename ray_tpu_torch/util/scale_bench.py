"""Scale benchmarks — many tasks, many actors, deep queues.

Role-equivalent to the reference's scalability envelope benchmarks
(ref: release/benchmarks/README.md:9-31 — 10k+ simultaneous tasks,
40k actors across a 2000-node cluster, 1M tasks queued on one 64-core
node) scaled to a single-machine budget: the point is a regression
canary on the control plane's many-task/many-actor paths (lease pool +
pipelined pushes + warm-worker adoption), not a cluster-scale proof,
which needs real fleet hardware the way the reference's release tests
do.

Run: ``python -m ray_tpu_torch.util.scale_bench [--record] [--quick]``.

Benchmarks:
- many_tasks_inflight: submit N no-op tasks at once, wait for all —
  end-to-end throughput with every task in flight simultaneously
  (ref: benchmarks/single_node "10k+ simultaneous tasks" row).
- queue_submit: raw owner-side submission rate with a deep backlog —
  N tasks enter the scheduling-key queue far faster than workers
  drain them (ref: "1M queued on one node": queueing must be cheap
  and memory-bounded independent of drain rate).  Only a slice of the
  queue is drained; the rest is cancelled in bulk (also a cancel-path
  stress).
- many_actors (N=50 and N=500, each in its own cluster session):
  create N cpu-free actors, round-trip one call on each, kill them
  (ref: "40k actors" row).  Runs through the warm-worker prestart
  pool: the pool is sized to the fleet and filled BEFORE the timed
  region, so the unit cost is an ADOPTION (pop an idle pre-spawned,
  pre-imported worker), not an interpreter spawn — each row reports
  the adopted vs cold_spawn_fallbacks delta as proof the fast path
  was hit.  Separate sessions keep the task benches untaxed by idle
  fleet processes they never use (and vice versa).
"""

from __future__ import annotations

import time
from typing import Any, Dict, List


def _pool_totals() -> Dict[str, float]:
    """Cluster-wide prestart-pool counters (adoption-vs-cold-spawn
    deltas bracket the actor benches)."""
    from . import state

    tot = {"idle": 0, "target": 0, "adoptions": 0, "cold_spawns": 0}
    for pool in state.worker_pools():
        for k in tot:
            tot[k] += pool.get(k, 0) or 0
    return tot


def wait_pool_fill(min_idle: int, timeout: float = 300.0) -> int:
    """Block until the warm prestart pool holds >= ``min_idle`` idle
    workers cluster-wide (the refill loop trickles spawns under its
    burst hysteresis, so a big pool takes a while on a small host).
    Returns the idle count reached."""
    deadline = time.time() + timeout
    idle = 0
    while time.time() < deadline:
        tot = _pool_totals()
        idle = int(tot["idle"])
        if idle >= min(min_idle, int(tot["target"]) or min_idle):
            return idle
        time.sleep(0.5)
    return idle


def bench_actor_fleet(n_actors: int, attempts: int = 3
                      ) -> Dict[str, Any]:
    """Create/ping/kill an ``n_actors`` fleet through the adoption
    fast path, median of ``attempts`` (the pool is refilled between
    attempts — timing a half-empty pool would measure the refill, not
    the adoption)."""
    import ray_tpu_torch

    @ray_tpu_torch.remote(num_cpus=0)
    class Probe:
        def ping(self):
            return 1

    rates = []
    dt = 0.0
    before = _pool_totals()
    for _ in range(attempts):
        # Wait for the FULL pool, then a settle beat: a refill still
        # forking replacements (from the previous attempt's kills)
        # would steal CPU from the timed region.
        wait_pool_fill(n_actors + 14, timeout=900.0)
        time.sleep(1.0)
        t0 = time.perf_counter()
        actors = [Probe.remote() for _ in range(n_actors)]
        ray_tpu_torch.get([a.ping.remote() for a in actors], timeout=600)
        for a in actors:
            ray_tpu_torch.kill(a)
        dt = time.perf_counter() - t0
        rates.append(n_actors / dt)
    after = _pool_totals()
    rates.sort()
    row = {"benchmark": f"many_actors_{n_actors}",
           "value": round(rates[len(rates) // 2], 1),
           "unit": "ops/s",
           "total": n_actors, "seconds": round(dt, 2),
           "attempts": attempts,
           "adopted": int(after["adoptions"] - before["adoptions"]),
           "cold_spawn_fallbacks": int(after["cold_spawns"]
                                       - before["cold_spawns"])}
    print(row, flush=True)
    return row


def run(quick: bool = False) -> List[Dict[str, Any]]:
    import ray_tpu_torch

    results: List[Dict[str, Any]] = []

    @ray_tpu_torch.remote
    def nop():
        return None

    def _timeit(name, fn, n):
        t0 = time.perf_counter()
        fn()
        dt = time.perf_counter() - t0
        row = {"benchmark": name,
               "value": round(n / dt, 1), "unit": "ops/s",
               "total": n, "seconds": round(dt, 2)}
        print(row, flush=True)
        results.append(row)

    # -- many tasks in flight -------------------------------------------
    n_tasks = 1000 if quick else 10_000
    ray_tpu_torch.get([nop.remote() for _ in range(50)], timeout=120)  # warm

    def many_tasks():
        ray_tpu_torch.get([nop.remote() for _ in range(n_tasks)],
                    timeout=600)

    _timeit(f"many_tasks_inflight_{n_tasks}", many_tasks, n_tasks)

    # Phase decomposition rows riding the same ledger: where the mean
    # sampled task's latency went during the inflight storm (the
    # default 1-in-64 RT_HOTPATH_SAMPLE stride yields ~150 records at
    # 10k tasks).  unit="share" rows are informational — perf_ledger
    # never judges them against best-ever.
    try:
        from . import state

        time.sleep(1.2)  # owner's 0.5s event-flush tick carries them
        snap = state.hotpath()
        if snap.get("count"):
            for ph in snap.get("phases", []):
                row = {"benchmark":
                       f"tasks_inflight_phase_{ph['phase']}",
                       "value": round(ph.get("share", 0.0), 4),
                       "unit": "share",
                       "total": int(ph.get("count", 0)),
                       "seconds": round(ph.get("mean_s", 0.0), 6)}
                print(row, flush=True)
                results.append(row)
    except Exception as e:  # sampling disabled / old controller
        print(f"hotpath decomposition unavailable: {e}", flush=True)

    # -- deep queue: submission rate + bulk cancel ----------------------
    n_queue = 10_000 if quick else 100_000
    drain = 1000

    t0 = time.perf_counter()
    refs = [nop.remote() for _ in range(n_queue)]
    submit_dt = time.perf_counter() - t0
    ray_tpu_torch.get(refs[:drain], timeout=600)
    for r in refs[drain:]:
        ray_tpu_torch.cancel(r)
    row = {"benchmark": f"queue_submit_{n_queue}",
           "value": round(n_queue / submit_dt, 1),
           "unit": "ops/s", "total": n_queue,
           "seconds": round(submit_dt, 2)}
    print(row, flush=True)
    results.append(row)
    # Let cancellations settle so the actor phase starts clean.
    time.sleep(1.0)

    return results


def main() -> None:
    import argparse

    import ray_tpu_torch

    parser = argparse.ArgumentParser()
    parser.add_argument("--quick", action="store_true")
    parser.add_argument("--record", action="store_true")
    parser.add_argument("--ledger", default=None,
                        help="ledger path for --record")
    args = parser.parse_args()
    # Actor creation may still fall back to a real process spawn; on a
    # loaded CI host many concurrent interpreter starts can exceed the
    # default readiness bound.  Must be set BEFORE init so the
    # driver's config snapshot carries it.
    import os as _os

    _os.environ.setdefault("RT_ACTOR_READY_TIMEOUT_S", "600")
    # Each bench family gets its own session so one path's apparatus
    # cannot tax another's timed region on a small host: the TASK
    # benches run with the default prestart pool (comparable to their
    # pre-pool records — a fleet-sized pool of idle processes steals
    # submit-loop cycles), while each ACTOR fleet gets a pool sized to
    # the fleet, filled before timing (the point of many_actors is the
    # ADOPTION fast path; cold_spawn_fallbacks per row reports when
    # the pool was outrun).
    owns = not ray_tpu_torch.is_initialized()
    if owns:
        ray_tpu_torch.init(mode="cluster", num_cpus=4)
    try:
        results = run(quick=args.quick)
    finally:
        if owns:
            ray_tpu_torch.shutdown()
    fleets = [10] if args.quick else [50, 500]
    for n_fleet in fleets if owns else []:
        _os.environ["RT_WORKER_PRESTART"] = str(n_fleet + 14)
        _os.environ["RT_WORKER_POOL_MAX_WORKERS"] = str(n_fleet + 64)
        # Burst stays LOW: a wide refill herd forked mid-attempt (the
        # replacements for the previous attempt's kills) steals the
        # timed region's CPU on a small host; 4 trickles it.
        _os.environ["RT_WORKER_PRESTART_BURST"] = "4"
        # A 500-process fill on a small host can starve the agent's
        # loop past the default 5-missed-heartbeat death sentence;
        # tolerate long stalls for the bench session (the controller
        # also re-registers a heartbeating "dead" agent now, but the
        # death/restart churn would still pollute the measurement).
        _os.environ["RT_HEALTH_CHECK_FAILURE_THRESHOLD"] = "120"
        ray_tpu_torch.init(mode="cluster", num_cpus=4)
        try:
            filled = wait_pool_fill(n_fleet + 8, timeout=900.0)
            print(f"prestart pool warm ({n_fleet}-fleet): {filled} "
                  f"idle worker(s)", flush=True)
            results.append(bench_actor_fleet(
                n_fleet, attempts=1 if n_fleet >= 500 else 3))
        finally:
            ray_tpu_torch.shutdown()
    import json

    for r in results:
        print(json.dumps(r))
    if args.record:
        from . import perf_ledger

        perf_ledger.record(results, source="scale", path=args.ledger)


if __name__ == "__main__":
    main()
