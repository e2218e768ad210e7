"""repro_torch's simulator core and cost front end against the JAX
package's (CPU).

The copied modules (``core/{topology,system,trace,simulate,roofline}``,
the serial engine, the analytic fabric) are held to the reference with
``==``: one ``HloCost``, converted field by field into the port's
records, gives equal ``simulate(...).summary()``s, ``build_runops`` and
``build_terms``, for the reference's own ``analyze()`` of the smoke loss
and for synthetic costs with each collective kind, at device_limit 1 and
4, healthy and through the fault what-ifs.

The tracer (``core/hlo.py::analyze``): matrix-product FLOPs equal to the
count from the config; total FLOPs within 10 % of the reference
``analyze()`` of the same loss (both count the products exactly and
every other op one FLOP per output element, but over different op sets:
XLA's fused elementwise graph against eager aten ops; measured 0.958 of
the reference on the CPU and 0.959 on meta); one trace op per kernel
call on the kernel path; a full-width qwen2-1.5b traced on ``meta``
without its weights."""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_mkl import init_vml  # noqa: E402

init_vml()      # before any test: tests/_torch_mkl.py says why

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as J  # noqa: E402
import repro.core.hlo as JH  # noqa: E402
import repro_torch.core as P  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import get_config as jget_config  # noqa: E402
from repro_torch.core import hlo  # noqa: E402
from repro_torch.kernels import cost as kcost  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import api, get_config  # noqa: E402
from repro_torch.patterns import Mesh  # noqa: E402
from repro_torch.sharding import umode  # noqa: E402
from repro_torch.train import optim  # noqa: E402
from _torch_sim_nodes import convert_cost, pkg, run_in_child  # noqa: E402,E501

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "qwen2-1.5b-smoke"
KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")


# ---------------------------------------------------------------------------
# costs to replay, and their conversion into the port's records
# ---------------------------------------------------------------------------

def _reference_loss_cost():
    """The reference's analyze() of the smoke loss, lowered as
    examples/quickstart.py lowers it."""
    cfg = jget_config(ARCH)
    batch = {"tokens": jax.ShapeDtypeStruct((4, 32), jnp.int32),
             "targets": jax.ShapeDtypeStruct((4, 32), jnp.int32)}
    compiled = jax.jit(lambda p, b: japi.loss(p, cfg, b)).lower(
        jax.eval_shape(lambda: japi.init(jax.random.PRNGKey(0), cfg)),
        batch).compile()
    return J.analyze(compiled.as_text())


def _synthetic_cost(kind, pod, layers=3):
    """layers x (compute + one collective of ``kind``): over the rows of
    the pod, or (collective-permute) over pairs of a row."""
    rows, cols = pod
    if kind == "collective-permute":
        groups = [[r * cols + c, r * cols + c + 1] for r in range(rows)
                  for c in range(0, cols, 2)]
    else:
        groups = [[r * cols + c for c in range(cols)] for r in range(rows)]
    if kind == "all-reduce":                   # and one across the pod
        groups = [list(range(rows * cols))]
    cost = J.HloCost()
    for i in range(layers):
        flops, nbytes, coll = 1e9 * (i + 1), 3e6 * (i + 1), 2.5e5 * (i + 1)
        cost.trace.append(JH.TraceOp("compute", f"seg{i}", flops=flops,
                                    hbm_bytes=nbytes))
        rec = J.CollectiveRecord(kind, f"c{i}", coll, int(coll), int(coll),
                                 groups, count=1.0 + i)
        cost.collectives.append(rec)
        cost.trace.append(JH.TraceOp("collective", f"c{i}", collective=rec,
                                    repeat=1.0 + i))
        cost.flops += flops
        cost.hbm_bytes += nbytes
    return cost


_COSTS = {}


def _cost(name):
    """Reference HloCosts by name, built once."""
    if name not in _COSTS:
        if name == "loss":
            _COSTS[name] = _reference_loss_cost()
        else:
            kind, pod = name.split("@")
            _COSTS[name] = _synthetic_cost(
                kind, tuple(int(x) for x in pod.split("x")))
    return _COSTS[name]


COST_NAMES = ["loss"] + [f"{k}@{p}" for k in KINDS for p in ("2x2", "4x4")]


def _port_cost(c) -> P.HloCost:
    """The reference HloCost ``c`` as the port's records, field by field."""
    recs = {}

    def rec(r):
        if r is None:
            return None
        if id(r) not in recs:
            recs[id(r)] = P.CollectiveRecord(**{
                f.name: getattr(r, f.name) for f in dataclasses.fields(r)})
        return recs[id(r)]
    trace = [P.TraceOp(**{f.name: (rec(op.collective) if f.name ==
                                   "collective" else getattr(op, f.name))
                          for f in dataclasses.fields(op)})
             for op in c.trace]
    return P.HloCost(flops=c.flops, hbm_bytes=c.hbm_bytes,
                     collectives=[rec(r) for r in c.collectives],
                     trace=trace, unknown_trip_counts=c.unknown_trip_counts)


def _spec(pkg, name):
    pod = (4, 4) if name.endswith("4x4") else (2, 2)
    return pkg.SystemSpec(pod_shape=pod)


# ---------------------------------------------------------------------------
# the copies against the reference, with ==
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("device_limit", [1, 4])
@pytest.mark.parametrize("name", COST_NAMES)
def test_simulate_summary_equals_reference(name, device_limit):
    jc = _cost(name)
    got = P.simulate(cost=_port_cost(jc), spec=_spec(P, name),
                     device_limit=device_limit)
    want = J.simulate(cost=jc, spec=_spec(J, name), device_limit=device_limit)
    assert got.summary() == want.summary()
    assert got.time_s > 0 and got.devices_done == got.devices


@pytest.mark.parametrize("device_limit", [1, 4])
@pytest.mark.parametrize("name", COST_NAMES)
def test_what_if_straggler_equals_reference(name, device_limit):
    jc = _cost(name)
    got = P.what_if_straggler(_port_cost(jc), _spec(P, name), device=0,
                              slow_factor=3.0, device_limit=device_limit)
    want = J.what_if_straggler(jc, _spec(J, name), device=0,
                               slow_factor=3.0, device_limit=device_limit)
    assert [r.summary() for r in got] == [r.summary() for r in want]
    assert got[1].time_s > got[0].time_s


@pytest.mark.parametrize("device_limit", [1, 4])
@pytest.mark.parametrize("name", COST_NAMES)
def test_what_if_failure_equals_reference(name, device_limit):
    jc = _cost(name)
    got = P.what_if_failure(_port_cost(jc), _spec(P, name), device=0,
                            deadline_s=1e-3, device_limit=device_limit)
    want = J.what_if_failure(jc, _spec(J, name), device=0, deadline_s=1e-3,
                             device_limit=device_limit)
    assert got.summary() == want.summary()


@pytest.mark.parametrize("name", COST_NAMES)
def test_build_runops_equals_reference(name):
    jc = _cost(name)
    for cap in (64, 2):
        got = P.build_runops(_port_cost(jc), repeat_cap=cap)
        want = J.build_runops(jc, repeat_cap=cap)
        assert [dataclasses.asdict(o) for o in got] == \
            [dataclasses.asdict(o) for o in want]


@pytest.mark.parametrize("name", COST_NAMES)
def test_build_terms_equals_reference(name):
    jc = _cost(name)
    ca = {"flops": jc.flops * 0.5, "bytes accessed": jc.hbm_bytes * 2}
    got = P.build_terms(f"{ARCH}/{name}", "(2,2)", 4, ca, _port_cost(jc),
                        _spec(P, name), model_flops_global=1e9)
    want = J.build_terms(f"{ARCH}/{name}", "(2,2)", 4, ca, jc,
                         _spec(J, name), model_flops_global=1e9)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert P.format_table([got]) == J.format_table([want])


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("groups", [[[0, 1]], [[0, 1, 2, 3]],
                                    [[0, 4, 8, 12]], [list(range(16))],
                                    [[0, 5], [10, 15]]],
                         ids=["pair", "row", "column", "pod", "diagonal"])
def test_collective_time_equals_reference(kind, groups):
    got, want = (pkg.Topology(pkg.SystemSpec(pod_shape=(4, 4), num_pods=2))
                 for pkg in (P, J))
    for nbytes in (1.0, 4096.0, 3.3e7):
        assert got.collective_time_s(kind, nbytes, groups) == \
            want.collective_time_s(kind, nbytes, groups)
    assert got.link_report() == want.link_report()


# ports of tests/test_sim_system.py's bodies against the port's copy

def _ring_cost(n_devices=8, layers=4, flops=1e9, nbytes=1e6, coll_bytes=1e5):
    groups = [list(range(n_devices))]
    cost = P.HloCost()
    for i in range(layers):
        cost.trace.append(P.TraceOp("compute", f"seg{i}", flops=flops,
                                    hbm_bytes=nbytes))
        rec = P.CollectiveRecord("all-reduce", f"ar{i}", coll_bytes,
                                 int(coll_bytes), int(coll_bytes), groups)
        cost.collectives.append(rec)
        cost.trace.append(P.TraceOp("collective", f"ar{i}", collective=rec))
        cost.flops += flops
        cost.hbm_bytes += nbytes
    return cost


SMALL = P.SystemSpec(pod_shape=(2, 4), num_pods=1)


def _completes_all_devices():
    rep = P.simulate(cost=_ring_cost(), spec=SMALL, device_limit=None)
    assert rep.devices_done == 8
    assert rep.collectives_completed == 4
    assert rep.time_s > 0


def _compute_time_matches_roofline():
    c = SMALL.chip
    cost = P.HloCost(flops=1e9, hbm_bytes=1e3, trace=[
        P.TraceOp("compute", "seg", flops=1e9, hbm_bytes=1e3)])
    rep = P.simulate(cost=cost, spec=SMALL, device_limit=1)
    expect = 1e9 / c.peak_bf16_flops + c.op_launch_overhead_s
    assert rep.time_s == pytest.approx(expect, rel=1e-6)


def _memory_bound_op_uses_hbm_time():
    c = SMALL.chip
    cost = P.HloCost(trace=[P.TraceOp("compute", "s", flops=1.0,
                                      hbm_bytes=1e9)])
    rep = P.simulate(cost=cost, spec=SMALL, device_limit=1)
    expect = 1e9 / c.hbm_bandwidth + c.op_launch_overhead_s
    assert rep.time_s == pytest.approx(expect, rel=1e-6)


def _subgroup_timing_invariant():
    groups = [[0, 1, 2, 3], [4, 5, 6, 7]]
    cost = P.HloCost()
    rec = P.CollectiveRecord("all-reduce", "ar", 1e6, int(1e6), int(1e6),
                             groups)
    cost.collectives.append(rec)
    cost.trace = [P.TraceOp("compute", "seg", flops=1e9, hbm_bytes=1e6),
                  P.TraceOp("collective", "ar", collective=rec)]
    full = P.simulate(cost=cost, spec=SMALL, device_limit=None)
    sub = P.simulate(cost=cost, spec=SMALL, device_limit=4)
    assert sub.devices == 4
    assert sub.time_s == pytest.approx(full.time_s, rel=1e-9)


def _trace_builder_caps_repeats():
    cost = P.HloCost()
    rec = P.CollectiveRecord("all-reduce", "ar", 1e4, int(1e4), int(1e4),
                             [[0, 1]], count=128.0)
    cost.trace = [P.TraceOp("compute", "c", flops=1e6, hbm_bytes=1e3,
                            repeat=128.0),
                  P.TraceOp("collective", "ar", collective=rec)]
    runops = P.build_runops(cost, repeat_cap=16)
    colls = [op for op in runops if op.kind == "collective"]
    segs = [op for op in runops if op.kind == "compute"]
    assert len(colls) == 16                  # capped
    assert sum(op.bytes for op in colls) == pytest.approx(128 * 1e4)
    assert sum(op.flops for op in segs) == pytest.approx(128 * 1e6)


@pytest.mark.parametrize("case", [
    _completes_all_devices, _compute_time_matches_roofline,
    _memory_bound_op_uses_hbm_time, _subgroup_timing_invariant,
    _trace_builder_caps_repeats], ids=lambda f: f.__name__.strip("_"))
def test_sim_system_on_the_port(case):
    case()


@pytest.mark.parametrize("kw", [
    dict(scheduler="batch"), dict(scheduler="lookahead"),
    dict(scheduler="bounded"), dict(executor="threads"),
    dict(executor="procs"), dict(fabric="event")],
    ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_what_the_copy_lost_now_runs(kw):
    """The schedulers, executors and the event fabric the serial-only
    copy lacked now run: the port's summary equals its own serial run on
    the same fabric and the reference's run with the same keyword.  The
    ``procs`` case runs in a fresh interpreter (``procs`` forks, and this
    process holds JAX's and torch's threads), against the reference's
    serial summary."""
    if kw.get("executor") == "procs":
        got = run_in_child("_torch_sim_cases", [
            ("procs", "simulate_keyword", [sorted(kw.items())])],
            with_ref=True)
        assert got["procs"] == "ok", got["procs"]
        return
    oracle = P.simulate(cost=_ring_cost(), spec=SMALL, device_limit=None,
                        fabric=kw.get("fabric", "analytic")).summary()
    want = J.simulate(cost=convert_cost(_ring_cost(), pkg("repro")),
                      spec=J.SystemSpec(pod_shape=(2, 4)),
                      device_limit=None, **kw).summary()
    got = P.simulate(cost=_ring_cost(), spec=SMALL, device_limit=None, **kw)
    assert got.summary() == oracle == want


def test_simulate_takes_no_hlo_text():
    with pytest.raises(ValueError, match="HloCost"):
        P.simulate(hlo_text="HloModule m", spec=SMALL)


# ---------------------------------------------------------------------------
# the tracer
# ---------------------------------------------------------------------------

def _batch(device, B=4, S=32):
    return {k: torch.zeros((B, S), dtype=torch.int32, device=device)
            for k in ("tokens", "targets")}


def _matmul_params(cfg) -> int:
    """Weights of the products a token passes through: the projections
    and the MLP of every layer and the unembedding."""
    d = cfg.d_model
    per_layer = d * (2 * cfg.q_dim + 2 * cfg.kv_dim) + 3 * d * cfg.d_ff
    return cfg.num_layers * per_layer + d * cfg.padded_vocab


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_loss_matmul_flops_equal_the_config_count(device):
    """attn_impl='ref': the projections, MLP and unembedding (2 x params
    x tokens) and the materialised QK^T and PV (2 x 2 B H S^2 hd a
    layer)."""
    cfg = get_config(ARCH)
    assert cfg.attn_impl == "ref"
    B, S = 4, 32
    cost = hlo.analyze(api.loss, api.init(0, cfg, device=device), cfg,
                       _batch(device, B, S))
    attn = 2 * 2 * B * cfg.num_heads * S * S * cfg.hd * cfg.num_layers
    assert hlo.matmul_flops(cost) == 2 * _matmul_params(cfg) * B * S + attn
    assert cost.flops > hlo.matmul_flops(cost) and cost.hbm_bytes > 0


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_loss_flops_near_the_reference_analyzer(device, capsys):
    cfg = get_config(ARCH)
    got = hlo.analyze(api.loss, api.init(0, cfg, device=device), cfg,
                      _batch(device))
    want = _cost("loss")
    ratio = got.flops / want.flops
    with capsys.disabled():
        print(f"\n  {device}: traced / reference FLOPs {ratio:.4f}, HBM "
              f"bytes {got.hbm_bytes / want.hbm_bytes:.4f} (not gated: "
              f"eager does not fuse)")
    assert abs(ratio - 1) <= 0.10


def _kernel_ops(cost):
    return {k: v for k, v in hlo.count_ops(cost).items()
            if not k.startswith("aten.")}


def test_kernel_path_forward_has_one_op_per_kernel_call():
    cfg = get_config(ARCH).replace(attn_impl="flash")
    L = cfg.num_layers
    cost = hlo.analyze(api.loss, api.init(0, cfg, device="meta"), cfg,
                       _batch("meta"))
    assert _kernel_ops(cost) == {"flash_attention": L, "rmsnorm": 1,
                                 "add_rmsnorm": 2 * L}
    assert ops.launch_counts() == {k: 0 for k in ops.launch_counts()}
    q = torch.empty((4, 32, cfg.num_heads, cfg.hd), device="meta")
    k = torch.empty((4, 32, cfg.num_kv_heads, cfg.hd), device="meta")
    flash = [op for op in cost.trace if op.name == "flash_attention"]
    assert (flash[0].flops, flash[0].hbm_bytes) == \
        kcost.flash_attention(q, k)


def test_kernel_path_train_step_matches_the_launch_counts():
    """One make_train_step step on meta: the kernel ops of a step (the
    counts chip_smoke.py's phase 8 reads off the launch counters) and
    3x the forward's products (dX and dW of each)."""
    cfg = get_config(ARCH).replace(attn_impl="flash")
    L = cfg.num_layers
    state = optim.init_state(api.init(0, cfg, device="meta"))
    cost = hlo.analyze(umode.make_train_step(cfg, optim.OptConfig()),
                       state, _batch("meta"))
    assert _kernel_ops(cost) == {
        "flash_attention": L, "flash_attention_bwd": L, "rmsnorm": 1,
        "rmsnorm_bwd": 1, "add_rmsnorm": 2 * L, "add_rmsnorm_bwd": 2 * L}
    assert hlo.matmul_flops(cost) == 3 * 2 * _matmul_params(cfg) * 4 * 32


FULL_WIDTH = r"""
import json, resource, torch
from torch.utils._pytree import tree_leaves
from repro_torch.core import hlo
from repro_torch.models import api, get_config
devices = set()
real = hlo._Tracer.__torch_dispatch__
def spy(self, func, types, args=(), kwargs=None):
    out = real(self, func, types, args, kwargs)
    devices.update(t.device.type for t in tree_leaves((args, kwargs, out))
                   if isinstance(t, torch.Tensor))
    return out
hlo._Tracer.__torch_dispatch__ = spy
cfg = get_config("qwen2-1.5b")
p = api.init(0, cfg, device="meta")
assert api.param_count(p) == cfg.param_count()
b = {k: torch.zeros((2, 1024), dtype=torch.int32, device="meta")
     for k in ("tokens", "targets")}
cost = hlo.analyze(api.loss, p, cfg, b)
kernels = {k: v for k, v in hlo.count_ops(cost).items()
           if not k.startswith("aten.")}
print(json.dumps([sorted(devices), kernels, hlo.matmul_flops(cost),
                  resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024]))
"""


def test_full_width_forward_traces_on_meta_without_its_weights():
    """qwen2-1.5b at full width (bf16 weights: 3.5 GB) traced in a fresh
    process: every tensor the trace saw lies on meta, and the process's
    peak RSS stays under 1.5 GB."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, "-c", FULL_WIDTH], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    devices, kernels, mm, rss = json.loads(proc.stdout)
    cfg = get_config("qwen2-1.5b")
    assert devices == ["meta"]
    assert kernels == {"flash_attention": 28, "rmsnorm": 1,
                       "add_rmsnorm": 56}
    assert mm == 2 * _matmul_params(cfg) * 2 * 1024
    assert rss < 1.5e9 < 3.5e9 <= 2 * cfg.param_count()


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


_WRAPPER_CALLS = {
    "flash_attention": lambda: ops.flash_attention(
        _meta(1, 8, 2, 16), _meta(1, 8, 1, 16), _meta(1, 8, 1, 16)),
    "flash_attention_bwd": lambda: ops.flash_attention_bwd(
        _meta(1, 8, 2, 16), _meta(1, 8, 1, 16), _meta(1, 8, 1, 16),
        _meta(1, 8, 2, 16), _meta(1, 2, 8), _meta(1, 8, 2, 16)),
    "rmsnorm": lambda: ops.rmsnorm(_meta(4, 8), _meta(8)),
    "rmsnorm_bwd": lambda: ops.rmsnorm_bwd(_meta(4, 8), _meta(8),
                                           _meta(4, 8)),
    "add_rmsnorm": lambda: ops.add_rmsnorm(_meta(4, 8), _meta(4, 8),
                                           _meta(8)),
    "add_rmsnorm_bwd": lambda: ops.add_rmsnorm_bwd(
        _meta(4, 8), _meta(8), _meta(4, 8), _meta(4, 8)),
    "gated_rmsnorm": lambda: ops.gated_rmsnorm(_meta(4, 8), _meta(4, 8),
                                               _meta(8)),
    "gated_rmsnorm_bwd": lambda: ops.gated_rmsnorm_bwd(
        _meta(4, 8), _meta(4, 8), _meta(8), _meta(4, 8)),
    "ssd_chunk_kernel": lambda: ops.ssd_chunk_kernel(
        _meta(1, 2, 4, 8), _meta(1, 2, 4), _meta(1, 2, 4),
        _meta(1, 2, 4, 16), _meta(1, 2, 4, 16)),
    "ssd_chunk_bwd": lambda: ops.ssd_chunk_bwd(
        _meta(1, 2, 4, 8), _meta(1, 2, 4), _meta(1, 2, 4),
        _meta(1, 2, 4, 16), _meta(1, 2, 4, 16), _meta(1, 2, 4, 8),
        _meta(1, 2, 16, 8)),
    "stencil2d": lambda: ops.stencil2d(_meta(8, 8), _meta(3, 3)),
    "bitonic_stage": lambda: ops.bitonic_stage(_meta(16), 1, 2),
    "bitonic_block": lambda: ops.bitonic_block(_meta(16), 2),
}


@pytest.mark.parametrize("name", sorted(_WRAPPER_CALLS))
def test_wrappers_raise_on_meta_outside_analyze(name):
    with pytest.raises(RuntimeError, match="meta"):
        _WRAPPER_CALLS[name]()


@pytest.mark.parametrize("name", sorted(_WRAPPER_CALLS))
def test_wrappers_trace_one_op_on_meta(name):
    cost = hlo.analyze(_WRAPPER_CALLS[name])
    assert [op.name for op in cost.trace] == [name]
    assert cost.trace[0].flops > 0 and cost.trace[0].hbm_bytes > 0


def test_traced_mesh_collective_raises():
    """A mesh collective inside ``analyze`` records one all-reduce (it
    raised before the tracer had collectives); a functional collective the
    tracer does not price still raises, naming it."""
    mesh = Mesh(["cpu"] * 2)
    xs = [torch.ones(4), torch.ones(4)]
    cost = hlo.analyze(mesh.psum, xs)
    assert [(c.kind, c.payload_bytes, c.groups) for c in cost.collectives] \
        == [("all-reduce", 16, [[0, 1]])]
    assert [op.kind for op in cost.trace] == ["collective"]
    assert mesh.psum(xs)[0].tolist() == [2.0] * 4       # untraced: fine
    from torch.distributed import _functional_collectives as funcol
    from repro_torch.patterns.unified import fake_mesh
    with fake_mesh(2) as dm:
        with pytest.raises(NotImplementedError, match="broadcast"):
            hlo.analyze(lambda t: funcol.broadcast(t, 0, dm),
                        torch.empty(4, device="meta"))


def test_chunked_loss_train_step_recomputes_the_unembed(monkeypatch):
    """With the chunked loss (threshold lowered), a train step's products
    are the unchunked step's plus one more unembedding forward (each
    checkpointed chunk made again in the backward): the count phase 9(b)
    of chip_smoke.py holds the full-width step to."""
    from repro_torch.models import transformer
    cfg = get_config(ARCH).replace(attn_impl="flash")
    B, S = 4, 32
    monkeypatch.setattr(transformer, "XENT_CHUNK_THRESHOLD", 1)
    monkeypatch.setattr(transformer, "XENT_CHUNK", 8)
    state = optim.init_state(api.init(0, cfg, device="meta"))
    cost = hlo.analyze(umode.make_train_step(cfg, optim.OptConfig()),
                       state, _batch("meta", B, S))
    tokens = B * S
    assert hlo.matmul_flops(cost) == 3 * 2 * _matmul_params(cfg) * tokens \
        + 2 * tokens * cfg.d_model * cfg.padded_vocab
    assert _kernel_ops(cost) == {
        "flash_attention": 2, "flash_attention_bwd": 2, "rmsnorm": 1,
        "rmsnorm_bwd": 1, "add_rmsnorm": 4, "add_rmsnorm_bwd": 4}


def test_quickstart_torch_on_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", "quickstart_torch.py"),
         "--device", "cpu"], env=env, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = proc.stdout
    assert "served 4 requests" in out
    assert "flops=" in out and "dominant=" in out
    assert "simulated step time on a v5e chip:" in out
