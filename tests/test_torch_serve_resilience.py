"""The port's serve resilience plane against the JAX package's.

Every case of ``tests/test_serve_resilience.py`` runs through
``ray_tpu.serve.resilience`` and ``ray_tpu_torch.serve.resilience`` with
the same inputs: one injected clock (a list both packages' machines
read), seeded RNGs, the same fault sequences.  Each case returns what it
observed (deadline budgets, breaker states and open windows, admission
order and sheds, ``select_replica``'s choices, typed errors after a
pickle round trip); the two packages' records must be equal, exactly.

Then the failure cases of ``tests/test_serve.py`` as programs on one
cluster per package (the JAX one shut down before the port's starts):
a dead replica healed with no request, failover on replica death, a
user exception never retried, a typed stream interruption, a slow
stream's first frame and an abandoned stream's cleanup.
"""

import importlib
import pickle
import random
import threading
import time

import pytest

PACKAGES = ("ray_tpu", "ray_tpu_torch")


class _Pkg:
    def __init__(self, name: str):
        self.res = importlib.import_module(name + ".serve.resilience")
        self.err = importlib.import_module(name + ".core.errors")


PKGS = {name: _Pkg(name) for name in PACKAGES}


def _both(case):
    out = {name: case(pkg) for name, pkg in PKGS.items()}
    assert out["ray_tpu"], "the case observed nothing"
    assert out["ray_tpu_torch"] == out["ray_tpu"]
    return out["ray_tpu"]


# ------------------------------------------------------------ deadline
def deadline_budget(p):
    t = [100.0]
    d = p.res.Deadline(10.0, clock=lambda: t[0])
    seen = [(d.bounded, d.expired, d.remaining())]
    for burn in (4.0, 5.0, 1.5):          # three attempts' time
        t[0] += burn
        seen.append((d.expired, d.remaining(), d.elapsed()))
    return seen


def deadline_unbounded(p):
    d = p.res.Deadline(0.0, clock=lambda: 0.0)
    b = p.res.Deadline(500.0, clock=lambda: 0.0)
    return [d.bounded, d.expired, d.remaining(cap=120.0),
            b.remaining(cap=60.0), b.remaining()]


@pytest.mark.parametrize("case", [deadline_budget, deadline_unbounded],
                         ids=lambda c: c.__name__)
def test_deadlines_match_jax(case):
    _both(case)


# ------------------------------------------------------------- breaker
def _breaker(p, clock, threshold=3, reset_s=2.0, jitter=None):
    br = p.res.CircuitBreaker(failure_threshold=threshold,
                              reset_s=reset_s, clock=clock,
                              rng=random.Random(0))
    if jitter is not None:
        br._backoff.jitter = jitter
    return br


def breaker_trips(p):
    t = [0.0]
    br = _breaker(p, lambda: t[0], jitter=0.0)
    seen = [br.record_failure(), br.record_failure()]
    seen.append(br.record_success())      # success resets the streak
    seen += [br.record_failure() for _ in range(3)]
    return seen + [br.state, br.allow(), br.snapshot()]


def breaker_half_open(p):
    t = [0.0]
    br = _breaker(p, lambda: t[0], reset_s=2.0, jitter=0.0)
    for _ in range(3):
        br.record_failure()
    seen = [br.state]
    for now in (1.9, 2.1, 2.1):
        t[0] = now
        seen.append((br.allow(), br.state))
    seen += [br.record_success(), br.state, br.allow()]
    return seen


def breaker_backoff(p):
    """Seeded jitter kept on: the open windows themselves must match."""
    t = [0.0]
    br = _breaker(p, lambda: t[0], reset_s=2.0)
    for _ in range(3):
        br.record_failure()
    windows = [br._open_for]
    for _ in range(3):                    # failed half-open probes
        t[0] += br._open_for + 0.1
        windows.append((br.allow(), br.record_failure(), br._open_for))
    t[0] += br._open_for + 0.1
    windows.append((br.allow(), br.record_success(), br.state))
    for _ in range(3):
        br.record_failure()
    windows.append(br._open_for)
    return windows


def breaker_board(p):
    events = []
    board = p.res.BreakerBoard(failure_threshold=2, reset_s=60.0,
                               on_transition=lambda k, s: events.append(
                                   (k, s)))
    seen = [board.allow("a"), board.record_failure("a"),
            board.record_failure("a"), board.state("a"), list(events),
            board.allow("a")]
    board.record_failure("b")
    seen += [board.prune(["b"]), board.state("a"),
             sorted(board.snapshot()), board.record_success("b"),
             list(events)]
    return seen


@pytest.mark.parametrize("case", [breaker_trips, breaker_half_open,
                                  breaker_backoff, breaker_board],
                         ids=lambda c: c.__name__)
def test_breakers_match_jax(case):
    _both(case)


# ------------------------------------------------------ admission gate
def _wait_for(cond, timeout=5.0):
    deadline = time.time() + timeout
    while not cond() and time.time() < deadline:
        time.sleep(0.01)


def admission_shed_oldest(p):
    gate = p.res.AdmissionGate(max_queued=2, capacity=lambda: 1)
    holder = gate.admit()                 # occupies the only slot
    results = {}

    def waiter(name):
        try:
            with gate.admit(p.res.Deadline(10.0), "dep"):
                results[name] = "served"
        except p.res.RequestShedError as e:
            results[name] = ("shed", str(e))

    threads = []
    for name in ("oldest", "middle"):
        th = threading.Thread(target=waiter, args=(name,))
        th.start()
        threads.append(th)
        _wait_for(lambda: gate.depth() >= len(threads))
    depth_full = gate.depth()
    th = threading.Thread(target=waiter, args=("newest",))
    th.start()
    threads.append(th)
    _wait_for(lambda: "oldest" in results)
    shed_first = dict(results)
    holder.release()                      # slots free -> FIFO serve
    for th in threads:
        th.join(10)
    return [depth_full, shed_first, results, gate.depth(), gate.active()]


def admission_deadline(p):
    gate = p.res.AdmissionGate(max_queued=4, capacity=lambda: 1)
    holder = gate.admit()
    t0 = time.time()
    try:
        gate.admit(p.res.Deadline(0.3), "dep")
        got = "admitted"
    except p.res.RequestTimeoutError as e:
        got = (type(e).__name__, str(e))
    fast = time.time() - t0 < 5.0
    depth = gate.depth()                  # expired ticket removed
    holder.release()
    return [got, fast, depth, gate.active()]


def admission_grown_capacity(p):
    cap = [1]
    gate = p.res.AdmissionGate(max_queued=8, capacity=lambda: cap[0])
    holder = gate.admit()
    admitted = []

    def waiter(i):
        with gate.admit(p.res.Deadline(10.0), "dep"):
            admitted.append(i)
            time.sleep(0.3)

    threads = [threading.Thread(target=waiter, args=(i,))
               for i in range(4)]
    for th in threads:
        th.start()
    _wait_for(lambda: gate.depth() >= 4)
    before = (gate.depth(), list(admitted))
    cap[0] = 5            # scale-up: capacity grows with NO release
    _wait_for(lambda: len(admitted) >= 4)
    after = sorted(admitted)
    for th in threads:
        th.join(10)
    holder.release()
    return [before, after, gate.active(), gate.depth()]


def admission_disabled(p):
    gate = p.res.AdmissionGate(max_queued=0, capacity=lambda: 1)
    tickets = [gate.admit() for _ in range(10)]
    for tk in tickets:
        tk.release()
    seen = [gate.depth(), gate.active()]
    gate2 = p.res.AdmissionGate(max_queued=2, capacity=lambda: 0)
    with gate2.admit(p.res.Deadline(1.0)):
        with gate2.admit(p.res.Deadline(1.0)):
            seen += [gate2.depth(), gate2.active()]
    return seen + [gate2.active()]


@pytest.mark.parametrize("case", [admission_shed_oldest,
                                  admission_deadline,
                                  admission_grown_capacity,
                                  admission_disabled],
                         ids=lambda c: c.__name__)
def test_admission_matches_jax(case):
    _both(case)


# ----------------------------------------------------- fault taxonomy
def system_faults(p):
    e = p.err
    dual = e.make_task_error("ValueError('user bug')", "tb",
                             ValueError("user bug"))
    return [p.res.is_system_fault(x) for x in (
        e.ActorDiedError("abc", "died"), e.WorkerCrashedError("crashed"),
        e.ObjectLostError("deadbeef"), e.NodeDiedError("node gone"),
        ValueError("user bug"), dual, TimeoutError("slow"))] + [
        isinstance(dual, e.TaskError), isinstance(dual, ValueError)]


def typed_errors_pickle(p):
    out = []
    for err in (p.res.RequestShedError("dep", 5),
                p.res.RequestTimeoutError("dep", 1.5),
                p.res.ReplicasUnavailableError("dep", "all open"),
                p.res.StreamInterruptedError("dep", "ActorDiedError(...)",
                                             7)):
        back = pickle.loads(pickle.dumps(err))
        out.append((type(back).__name__, type(back) is type(err),
                    str(back), back.__reduce__()[1],
                    isinstance(back, TimeoutError)))
    return out


@pytest.mark.parametrize("case", [system_faults, typed_errors_pickle],
                         ids=lambda c: c.__name__)
def test_fault_taxonomy_matches_jax(case):
    _both(case)


# ----------------------------------------------------- replica select
class _Rep:
    def __init__(self, key):
        self._key = key
        self.actor_id = self

    def hex(self):
        return self._key


def _key(sel):
    return None if sel is None else sel[1]


def select_low_inflight(p):
    board = p.res.BreakerBoard(failure_threshold=3, reset_s=60.0)
    reps = [_Rep("a"), _Rep("b"), _Rep("c")]
    rng = random.Random(0)
    seen = [_key(p.res.select_replica(reps[:2], board,
                                      {"a": 5, "b": 0}, rng=rng)),
            _key(p.res.select_replica(reps[:2], board, {},
                                      exclude={"b"}, rng=rng)),
            _key(p.res.select_replica(reps[:2], board, {},
                                      exclude={"a", "b"}, rng=rng))]
    # Pow-2 over three: the seeded RNG's pairs, lower count first.
    seen += [_key(p.res.select_replica(reps, board,
                                       {"a": 2, "b": 1, "c": 0}, rng=rng))
             for _ in range(24)]
    return seen


def select_open_breakers(p):
    board = p.res.BreakerBoard(failure_threshold=1, reset_s=60.0)
    reps = [_Rep("a"), _Rep("b"), _Rep("c")]
    board.record_failure("a")            # trip a
    rng = random.Random(1)
    seen = [_key(p.res.select_replica(reps, board, {}, rng=rng))
            for _ in range(16)]
    board.record_failure("b")
    board.record_failure("c")
    return seen + [_key(p.res.select_replica(reps, board, {}, rng=rng))]


def select_probe_only_chosen(p):
    t = [0.0]
    board = p.res.BreakerBoard(failure_threshold=1, reset_s=1.0,
                               clock=lambda: t[0])
    reps = [_Rep("a")]
    board.record_failure("a")
    t[0] = 10.0                          # open window elapsed
    seen = [_key(p.res.select_replica(reps, board, {},
                                      rng=random.Random(0))),
            _key(p.res.select_replica(reps, board, {},
                                      rng=random.Random(0)))]
    board.record_success("a")            # probe succeeded
    return seen + [_key(p.res.select_replica(reps, board, {},
                                             rng=random.Random(0)))]


def select_after_drain(p):
    board = p.res.BreakerBoard(failure_threshold=3, reset_s=60.0)
    table = [_Rep("live1"), _Rep("drainme"), _Rep("live2")]
    bled = [r for r in table if r.actor_id.hex() != "drainme"]
    rng = random.Random(2)
    return [_key(p.res.select_replica(bled, board, {}, rng=rng))
            for _ in range(32)]


@pytest.mark.parametrize("case", [select_low_inflight,
                                  select_open_breakers,
                                  select_probe_only_chosen,
                                  select_after_drain],
                         ids=lambda c: c.__name__)
def test_select_replica_matches_jax(case):
    _both(case)


# ---------------------------------------------------- on a cluster
CASES = {}


def case(fn):
    CASES[fn.__name__] = fn
    return fn


def _until(cond, timeout: float, what: str, every: float = 0.2):
    deadline = time.time() + timeout
    while time.time() < deadline:
        got = cond()
        if got:
            return got
        time.sleep(every)
    raise TimeoutError(what)


@case
def dead_replica_healed(rt, serve, pkg):
    @serve.deployment(num_replicas=2)
    def stable(x):
        return x * 2

    handle = serve.run(stable.bind(), route_prefix="/stable")
    first = rt.get(handle.remote(21))
    ctl = rt.get_actor(serve.CONTROLLER_NAME)
    victim = rt.get(ctl.get_replicas.remote("stable"))[0]
    rt.kill(victim)

    def healed():        # no traffic at all: the loop heals on its own
        fresh = rt.get(ctl.get_replicas.remote("stable"))
        if len(fresh) != 2 or victim._actor_id in [r._actor_id
                                                   for r in fresh]:
            return False
        try:
            return rt.get(fresh[0].health.remote(), timeout=30)
        except Exception:
            return False

    _until(healed, 60, "dead replica never replaced", every=0.5)
    stats = rt.get(ctl.resilience_stats.remote())["stable"]
    return [first, rt.get(handle.remote(5)), stats["replicas"],
            [r["reason"] for r in stats["replacements"]]]



@case
def failover_on_replica_death(rt, serve, pkg):
    @serve.deployment(num_replicas=2, name="resil")
    def resil(x):
        return {"ok": x}

    handle = serve.run(resil.bind(), route_prefix="/resil")
    out = [handle.call(0)]
    ctl = rt.get_actor(serve.CONTROLLER_NAME)
    rt.kill(rt.get(ctl.get_replicas.remote("resil"))[0])
    # Every call after the kill succeeds through failover, well before
    # the control loop replaces the dead replica.
    out += [handle.call(i, timeout_s=30) for i in range(10)]
    return out



@case
def user_exception_never_retried(rt, serve, pkg):
    class Counter:
        def __init__(self):
            self.n = 0

        def incr(self):
            self.n += 1
            return self.n

        def get(self):
            return self.n

    counter = rt.remote(Counter).options(name="resil_counter",
                                         num_cpus=0).remote()
    rt.get(counter.get.remote())

    @serve.deployment(num_replicas=1, name="usererr")
    def usererr(x):
        m = importlib.import_module(pkg)
        m.get(m.get_actor("resil_counter").incr.remote())
        raise ValueError("handler bug")

    handle = serve.run(usererr.bind(), route_prefix="/usererr")
    try:
        handle.call({})
        raised = None
    except ValueError as e:
        raised = ("ValueError", "handler bug" in str(e))
    runs = rt.get(counter.get.remote())
    rt.kill(counter)
    assert raised == ("ValueError", True) and runs == 1
    return [raised, runs]



@case
def stream_interruption_is_typed(rt, serve, pkg):
    res = importlib.import_module(pkg + ".serve.resilience")

    @serve.deployment(num_replicas=1, name="hangstream")
    def hangstream(x):
        yield {"i": 0}
        yield {"i": 1}
        time.sleep(60)
        yield {"i": 2}

    handle = serve.run(hangstream.bind(), route_prefix="/hang")
    it = handle.stream({})
    got = [next(it), next(it)]
    ctl = rt.get_actor(serve.CONTROLLER_NAME)
    rt.kill(rt.get(ctl.get_replicas.remote("hangstream"))[0])
    try:
        next(it)
        raised = None
    except res.StreamInterruptedError as e:
        raised = ("StreamInterruptedError", e.items_delivered)
    assert raised == ("StreamInterruptedError", 2)
    return [got, raised]



@case
def slow_stream_and_abandon(rt, serve, pkg):
    @serve.deployment(name="slowgen", num_replicas=1)
    def slowgen(payload):
        for i in range(5):
            time.sleep(0.4)
            yield i

    @serve.deployment(name="badgen", num_replicas=1)
    def badgen(payload):
        yield 1
        raise ValueError("mid-stream explosion")

    handle = serve.run(slowgen.bind(), route_prefix="/slow")
    t0 = time.time()
    gen = handle.stream({})
    first = next(gen)
    prompt = time.time() - t0 < 6
    gen.close()       # abandon: the finally path cancels the replica's
    handle._ensure_fresh()
    rep = handle._replicas[0]
    _until(lambda: rt.get(rep.open_streams.remote(), timeout=30) == 0,
           15, "abandoned stream leaked in the replica", every=0.3)
    full = list(handle.stream({}))
    h2 = serve.run(badgen.bind(), route_prefix="/bad")
    try:
        list(h2.stream({}))
        raised = None
    except ValueError as e:
        raised = ("ValueError", "mid-stream explosion" in str(e))
    return [first, prompt, full, raised]


def _run_all(pkg: str) -> dict:
    rt = importlib.import_module(pkg)
    serve = importlib.import_module(pkg + ".serve")
    rt.init(mode="cluster", num_cpus=8)
    out = {}
    try:
        for name, fn in CASES.items():
            try:
                out[name] = fn(rt, serve, pkg)
            except Exception as e:  # noqa: BLE001 — recorded, compared
                out[name] = ("raised", repr(e)[:2000])
            finally:
                for dep in list(serve.status()):
                    serve.delete(dep)
    finally:
        serve.shutdown()
        rt.shutdown()
    return out


@pytest.fixture(scope="module")
def results():
    return {pkg: _run_all(pkg) for pkg in PACKAGES}


@pytest.mark.parametrize("name", list(CASES))
def test_resilience_program_matches_jax(results, name):
    jax_out, port_out = (results[pkg][name] for pkg in PACKAGES)
    assert not (isinstance(jax_out, tuple) and jax_out[:1] == ("raised",)), \
        jax_out
    assert port_out == jax_out


def test_a_replica_still_starting_is_not_replaced(results):
    """The port's serve controller (unlike the JAX package's) gives a
    replica that has never answered a health probe a startup grace:
    one whose constructor outlasts the 10 s probe is not replaced as
    dead (which would start another that outlasts it too), and it
    serves once up."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve

    @serve.deployment(num_replicas=1)
    class Slow:
        def __init__(self):
            time.sleep(13.0)

        def __call__(self, x):
            return x + 1

    rt.init(mode="cluster", num_cpus=4)
    try:
        handle = serve.run(Slow.bind(), route_prefix="/slow")
        assert rt.get(handle.remote(1), timeout=120) == 2
        ctl = rt.get_actor(serve.CONTROLLER_NAME)
        stats = rt.get(ctl.resilience_stats.remote())["Slow"]
        assert stats["replacements"] == []
        assert stats["replicas"] == 1
    finally:
        serve.shutdown()
        rt.shutdown()
