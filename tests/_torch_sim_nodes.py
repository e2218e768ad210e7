"""Shared workloads of the simulator parity tests, built on either package.

The reference's engine and executor tests build their workloads from
components that subclass ``repro.core.Component`` (their own test
classes, ``benchmarks/engine_scalability.py::JitterNode`` and
``benchmarks/engine_parallelism.py::synthetic_workload``).  ``pkg(name)``
builds the same classes, code for code, on ``name.core.Component`` for
``name`` in ``("repro", "repro_torch")``, so one builder runs the same
workload on the port and on the reference.

``run_in_child`` runs a list of cases in a fresh interpreter.  The
``procs`` executor forks its shard workers, and forking a process that
already runs JAX's or torch's threads (an xdist worker that ran an
earlier test file) can deadlock the child; a fresh interpreter that
imports neither JAX nor ``repro.serve`` has nothing to deadlock on.
"""
from __future__ import annotations

import dataclasses
import importlib
import json
import os
import random
import subprocess
import sys
import types

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
SRC = os.path.join(REPO, "src")


def _components(core):
    """The test and benchmark components, on ``core.Component``."""
    Component, Event, Request = core.Component, core.Event, core.Request

    class Ticker(Component):
        """Schedules `n` self events with given gaps; records handle
        times (tests/test_sim_engine.py)."""

        def __init__(self, name, gaps):
            super().__init__(name)
            self.gaps = list(gaps)
            self.log = []

        def start(self):
            self.schedule("tick", self.gaps[0])

        def handle(self, event):
            self.log.append((self.engine.now, event.kind))
            idx = len([e for e in self.log if e[1] == "tick"])
            if idx < len(self.gaps):
                self.schedule("tick", self.gaps[idx])

    class JitterNode(Component):
        """Device-analog whose op latencies diverge across devices
        (benchmarks/engine_scalability.py)."""

        def __init__(self, name, seed, ticks, send_every=40):
            super().__init__(name)
            self.rng = random.Random(seed)
            self.ticks = ticks
            self.count = 0
            self.received = 0
            self.send_every = send_every
            self.sig = 0

        def start(self):
            self.schedule("tick", self.rng.randint(50, 550))

        def handle(self, event):
            self.sig = hash((self.sig, self.engine.now, event.kind))
            if event.kind == "tick":
                self.count += 1
                if self.count % self.send_every == 0 and "out" in self.ports:
                    self.port("out").send(Request(src=self.port("out"),
                                                  dst=None, kind="ping",
                                                  size_bytes=64))
                if self.count < self.ticks:
                    self.schedule("tick", self.rng.randint(50, 550))
            else:
                self.received += 1

    class Sink(Component):
        def __init__(self, name):
            super().__init__(name)
            self.received = 0

        def handle(self, event):
            if event.kind == "request":
                self.received += 1

    class CountAll(Component):
        """tests/test_executor.py's ``Sink``: counts every event."""

        def __init__(self, name):
            super().__init__(name)
            self.received = 0

        def handle(self, event):
            self.received += 1

    class Counter(Component):
        def __init__(self, name):
            super().__init__(name)
            self.handled = 0

        def handle(self, event):
            self.handled += 1

    class Producer(Component):
        """Floods a LimitedConnection; waits for notify_available."""

        def __init__(self, name, total):
            super().__init__(name)
            self.total = total
            self.sent = 0
            self.rejected = 0
            self.notified = 0

        def start(self):
            self.schedule("go")

        def _try_send(self):
            while self.sent < self.total:
                req = Request(src=self.port("out"), dst=None, kind="data",
                              size_bytes=64)
                if not self.port("out").send(req):
                    self.rejected += 1
                    return
                self.sent += 1

        def handle(self, event):
            self._try_send()

        def notify_available(self, connection):
            self.notified += 1
            self._try_send()

    class RogueDispatcher(Component):
        """Posts a zero-latency event to a foreign component, bypassing
        the connection system."""

        def __init__(self, name, victim):
            super().__init__(name)
            self.victim = victim

        def start(self):
            self.schedule("go", 0)

        def handle(self, event):
            if event.kind == "go":
                self.engine.post(Event(time=self.engine.now,
                                       component=self.victim, kind="attack"))

    class ZeroDelayMixer(Component):
        def __init__(self, name):
            super().__init__(name)
            self.order = []

        def handle(self, event):
            self.order.append((self.engine.now, event.kind,
                               getattr(event.payload, "kind", event.payload)))
            if event.kind == "tick":
                self.schedule("after", 0, payload="self")

    class SameTimeSender(Component):
        def __init__(self, name, when):
            super().__init__(name)
            self.when = when

        def start(self):
            self.schedule("fire", self.when)

        def handle(self, event):
            if event.kind == "fire":
                self.port("out").send(Request(src=self.port("out"), dst=None,
                                              kind="poke", size_bytes=0))

    class DelayZeroChainer(Component):
        def __init__(self, name, sink):
            super().__init__(name)
            self.sink = sink

        def handle(self, event):
            if event.kind == "tick":
                self.schedule("after", 0)
            elif event.kind == "after":
                self.port("o").send(Request(src=self.port("o"),
                                            dst=self.sink, kind="a_msg",
                                            size_bytes=1000))

    class DirectSender(Component):
        def __init__(self, name, sink):
            super().__init__(name)
            self.sink = sink

        def handle(self, event):
            if event.kind == "tick":
                self.port("o").send(Request(src=self.port("o"),
                                            dst=self.sink, kind="c_msg",
                                            size_bytes=1000))

    class TimedSink(Component):
        def __init__(self, name):
            super().__init__(name)
            self.log = []

        def handle(self, event):
            if event.kind == "request":
                self.log.append((self.engine.now, event.payload.kind))

    class Echo(Component):
        def __init__(self, name):
            super().__init__(name)
            self.reply_ok = []

        def handle(self, event):
            if event.kind == "request" and event.payload.kind == "ask":
                self.reply_ok.append(self.port("p").send(Request(
                    src=self.port("p"), dst=event.payload.src.owner,
                    kind="answer", size_bytes=64)))

    class ChainStarter(Component):
        def __init__(self, name):
            super().__init__(name)
            self.log = []

        def handle(self, event):
            self.log.append((self.engine.now, event.kind))
            if event.kind == "tick":
                self.schedule("gen1", 0)
            elif event.kind == "gen1":
                self.schedule("gen2", 0)
            elif event.kind == "gen2":
                self.schedule("gen3", 0)

    class PastPoster(Component):
        def handle(self, event):
            if event.kind == "go":
                self.engine.post(Event(time=self.engine.now - 500,
                                       component=self, kind="too_late"))

    class Spray(Component):
        """Ticks and pings both ring neighbors with a distinct payload
        (tests/test_executor.py)."""

        def __init__(self, name, ticks):
            super().__init__(name)
            self.ticks = ticks
            self.count = 0
            self.sig = 0

        def start(self):
            self.schedule("tick", 100)

        def handle(self, event):
            if event.kind == "tick":
                self.count += 1
                for pname in ("fwd", "bwd"):
                    self.port(pname).send(Request(
                        src=self.port(pname), dst=None, kind="ping",
                        size_bytes=8, payload=(self.name, pname, self.count)))
                if self.count < self.ticks:
                    self.schedule("tick", 137)
            elif event.kind == "request":
                self.sig = hash((self.sig, self.engine.now,
                                 event.payload.payload))

    class Staller(Component):
        def start(self):
            for d in (100, 200, 300):
                self.schedule("stall", d, payload="x")

        def handle(self, event):
            pass

    class Suicider(Component):
        def start(self):
            self.schedule("tick", 100)

        def handle(self, event):
            os._exit(7)

    class Thrower(Component):
        def start(self):
            self.schedule("tick", 100)

        def handle(self, event):
            raise ValueError("handler exploded")

    return {k: v for k, v in locals().items() if isinstance(v, type)}


_PKGS: dict = {}


def pkg(name: str) -> types.SimpleNamespace:
    """The simulator modules of ``name`` ("repro" or "repro_torch") and
    the test components built on them (cached)."""
    if name not in _PKGS:
        mod = lambda m: importlib.import_module(f"{name}.{m}")  # noqa: E731
        ns = types.SimpleNamespace(
            name=name, core=mod("core"), hlo=mod("core.hlo"),
            system=mod("core.system"), hooks=mod("core.hooks"),
            topology=mod("core.topology"), fabric=mod("fabric"),
            plancache=mod("fabric.plancache"),
            event_fabric=mod("fabric.event"),
            rings=mod("core.engine.executor.rings"))
        ns.__dict__.update(_components(ns.core))
        _PKGS[name] = ns
    return _PKGS[name]


def serve_sim(ns):
    """``ns``'s serving simulator (the reference's imports JAX through
    ``repro/serve/__init__.py``, so it loads only when asked for)."""
    return importlib.import_module(f"{ns.name}.serve.sim")


# ---------------------------------------------------------------------------
# workloads
# ---------------------------------------------------------------------------

def synthetic_workload(ns, n_devices: int, layers: int = 12):
    """AES-analog: compute-heavy partitioned segments + periodic sync
    (benchmarks/engine_scalability.py)."""
    H = ns.hlo
    cost = H.HloCost()
    groups = [list(range(n_devices))]
    for i in range(layers):
        cost.trace.append(H.TraceOp("compute", f"seg{i}", flops=5e9,
                                    hbm_bytes=2e8))
        rec = H.CollectiveRecord("all-reduce", f"ar{i}", 1e6, int(1e6),
                                 int(1e6), groups)
        cost.collectives.append(rec)
        cost.trace.append(H.TraceOp("collective", f"ar{i}", collective=rec))
    return cost


def ar_cost(ns):
    """tests/test_executor.py's three compute + all-reduce layers."""
    H = ns.hlo
    ops, colls = [], []
    for i in range(3):
        ops.append(H.TraceOp("compute", f"mm{i}", flops=2e9, hbm_bytes=1e6))
        rec = H.CollectiveRecord("all-reduce", f"ar{i}", 2e5, int(2e5),
                                 int(2e5), [[0, 1, 2, 3]])
        colls.append(rec)
        ops.append(H.TraceOp("collective", f"ar{i}", collective=rec))
    return H.HloCost(collectives=colls, trace=ops)


def ring_cost(ns, n_devices=8, layers=4, flops=1e9, nbytes=1e6,
              coll_bytes=1e5):
    """tests/test_sim_system.py's ``_cost``: compute + a global
    all-reduce a layer."""
    H = ns.hlo
    groups = [list(range(n_devices))]
    cost = H.HloCost()
    for i in range(layers):
        cost.trace.append(H.TraceOp("compute", f"seg{i}", flops=flops,
                                    hbm_bytes=nbytes))
        rec = H.CollectiveRecord("all-reduce", f"ar{i}", coll_bytes,
                                 int(coll_bytes), int(coll_bytes), groups)
        cost.collectives.append(rec)
        cost.trace.append(H.TraceOp("collective", f"ar{i}", collective=rec))
        cost.flops += flops
        cost.hbm_bytes += nbytes
    return cost


def convert_cost(cost, ns):
    """An HloCost of either package as ``ns``'s records, field by field."""
    H = ns.hlo
    recs = {}

    def rec(r):
        if r is None:
            return None
        if id(r) not in recs:
            recs[id(r)] = H.CollectiveRecord(**{
                f.name: getattr(r, f.name) for f in dataclasses.fields(r)})
        return recs[id(r)]
    trace = [H.TraceOp(**{f.name: (rec(op.collective) if f.name ==
                                   "collective" else getattr(op, f.name))
                          for f in dataclasses.fields(op)})
             for op in cost.trace]
    return H.HloCost(flops=cost.flops, hbm_bytes=cost.hbm_bytes,
                     collectives=[rec(r) for r in cost.collectives],
                     trace=trace,
                     unknown_trip_counts=cost.unknown_trip_counts)


def build_jitter(ns, scheduler, executor=None, n=8, ticks=80,
                 send_every=20, max_workers=4):
    """The divergent-latency ring of JitterNodes; returns the node
    signatures, the end time and the engine."""
    eng = ns.core.Engine(scheduler=scheduler, executor=executor,
                         max_workers=max_workers)
    nodes = [eng.register(ns.JitterNode(f"n{i}", i, ticks,
                                        send_every=send_every))
             for i in range(n)]
    for i in range(n):
        conn = eng.register(ns.core.Connection(f"ring{i}", latency_s=4e-9))
        conn.plug(nodes[i].port("out")).plug(nodes[(i + 1) % n].port("in"))
    for nd in nodes:
        nd.start()
    end = eng.run()
    return [(nd.sig, nd.count, nd.received) for nd in nodes], end, eng


def grouped(ns, name, max_workers=4):
    """A round scheduler pinned to grouped (per-cluster) execution on
    every round (``pool_min_events = 0``)."""
    C = ns.core
    cls = {"batch": C.BatchParallelScheduler,
           "lookahead": C.LookaheadScheduler,
           "bounded": C.BoundedLagScheduler}[name]
    sched = cls(max_workers=max_workers)
    sched.pool_min_events = 0
    return sched


def sched_variant(ns, spec):
    """``"lookahead"`` by name, ``"lookahead-grouped"`` pinned grouped."""
    if spec.endswith("-grouped"):
        return grouped(ns, spec[: -len("-grouped")])
    return spec


# ---------------------------------------------------------------------------
# cases in a fresh interpreter
# ---------------------------------------------------------------------------

CHILD_TIMEOUT_S = 600          # the whole child; a case has CASE_TIMEOUT_S
CASE_TIMEOUT_S = 120


def child_env() -> dict:
    """The child's environment: this repo's sources first, and one
    thread for the numeric libraries (the simulator does no BLAS work,
    and their thread pools are what a fork would copy)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [SRC, TESTS, REPO] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH")
                              else []))
    for k in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        env[k] = "1"
    env.pop("XLA_FLAGS", None)
    return env


def run_in_child(module: str, cases: list, with_ref: bool) -> dict:
    """Run ``module.CASES[name](*args, with_ref=with_ref)`` for each
    ``(case_id, name, args)`` of ``cases`` in one fresh interpreter;
    returns ``{case_id: "ok" or the failure's traceback}``."""
    code = (f"import _torch_sim_nodes as n\n"
            f"n._child_main({module!r}, {cases!r}, {with_ref!r})\n")
    proc = subprocess.run([sys.executable, "-c", code], env=child_env(),
                          cwd=REPO, capture_output=True, text=True,
                          timeout=CHILD_TIMEOUT_S)
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("CASES ")]
    if proc.returncode != 0 or not lines:
        raise RuntimeError(f"child exited {proc.returncode}:\n"
                           f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    return json.loads(lines[-1][len("CASES "):])


def _child_main(module: str, cases: list,
                with_ref: bool) -> None:  # pragma: no cover
    import signal
    import traceback

    def alarm(signum, frame):
        raise TimeoutError(f"case exceeded {CASE_TIMEOUT_S} s")

    signal.signal(signal.SIGALRM, alarm)
    mod = importlib.import_module(module)
    out = {}
    for case_id, name, args in cases:
        signal.alarm(CASE_TIMEOUT_S)
        try:
            mod.CASES[name](*args, with_ref=with_ref)
            out[case_id] = "ok"
        except (KeyboardInterrupt, SystemExit):
            raise
        except BaseException:       # pytest.fail's Failed is one too
            out[case_id] = traceback.format_exc()
        finally:
            signal.alarm(0)
    bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib")
           or m.startswith("repro.serve")]
    if bad:
        out = {k: f"the child imported {sorted(bad)[:5]}" for k in out}
    print("CASES " + json.dumps(out), flush=True)
