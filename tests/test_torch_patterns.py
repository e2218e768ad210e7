"""repro_torch MGMark: every workload in U-mode and D-mode on a 4-shard
CPU mesh vs the JAX package's ``make_umode`` / ``make_dmode`` on 4 fake
XLA CPU devices, at tests/test_patterns.py's sizes; collective bytes,
records and priced time vs the reference's HLO count; the simulated
fields; ``make_args`` bit-equal; SC and BS D-mode on other mesh sizes;
the launcher and the pattern study on the CPU.

The JAX side runs once for the file, in one subprocess with 4 devices
(``conftest.run_with_devices``), and writes an ``.npz`` the tests read.
Tolerance: AES, MT and BS only move or xor values and must be equal; the
float workloads agree within 1e-5 (f32 sums in another order).  Counted
bytes, collective records, ``collective_sim_time`` and matrix-product
FLOPs are held with ``==``."""
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_mkl import init_vml  # noqa: E402

init_vml()      # before any test: tests/_torch_mkl.py says why

from conftest import REPO, run_with_devices  # noqa: E402
from repro.patterns import WORKLOADS as JWORKLOADS  # noqa: E402
from repro_torch.core import SystemSpec, hlo  # noqa: E402
from repro_torch.core.roofline import collective_sim_time  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import mgmark  # noqa: E402
from repro_torch.patterns import WORKLOADS, Mesh, aes, bs, evaluate  # noqa: E402,E501
from repro_torch.patterns.base import finite, trace  # noqa: E402

M = 4
SIZES = {"aes": 8192, "km": 2048, "fir": 8192, "sc": 128, "gd": 2048,
         "mt": 128, "bs": 2048}
# the reference's D-mode bytes per device at SIZES (its HLO count)
DMODE_BYTES = {"aes": 0, "km": 2112, "fir": 60, "sc": 1024, "gd": 8192,
               "mt": 16384, "bs": 6144}
# the port's U-mode bytes per device at SIZES: the collectives DTensor
# issues (km: the counts' clamp then the sums; fir: an all-gather of the
# signal for the pad; sc, bs: an all-gather of the whole image / array
# for the kernels; gd: 8 all-reduces; mt: one all-to-all)
UMODE_BYTES = {"aes": {}, "km": {"all-reduce": 2112.0},
               "fir": {"all-gather": 32768.0},
               "sc": {"all-gather": 65536.0}, "gd": {"all-reduce": 8192.0},
               "mt": {"all-to-all": 16384.0}, "bs": {"all-gather": 8192.0}}
# where DTensor's choice is GSPMD's (a reduction or a transpose); GSPMD
# sends halos by collective-permute (fir, sc) and gathers a stage at a
# time for the sort (bs)
UMODE_AS_REFERENCE = ("aes", "km", "gd", "mt")
# U-mode bytes at default_size(4), which chip_smoke.py phase 7 holds the
# card's traces to (MGMARK_UMODE_BYTES there)
UMODE_BYTES_DEFAULT = {"aes": 0, "km": 2112, "fir": 1048576,
                       "sc": 67108864, "gd": 8192, "mt": 67108864,
                       "bs": 524288}
EXACT = ("aes", "mt", "bs")
FLOAT_ATOL = 1e-5

_JAX_SCRIPT = """
import json
import numpy as np
import jax.numpy as jnp
from repro.core import SystemSpec, analyze
from repro.core.hlo import HloModule
from repro.core.roofline import collective_sim_time
from repro.patterns import WORKLOADS, evaluate
mesh = make_auto_mesh(({m},), ("dev",))
sizes = json.loads({sizes!r})
spec = SystemSpec(pod_shape=(1, {m}))


def dot_flops(mod, name):
    # the products of a computation, loops scaled by their trip counts
    comp = mod.computations[name]
    total = 0.0
    for ins in comp.instructions:
        if ins.opcode == "dot":
            total += mod._dot_flops(comp, ins)
        elif ins.opcode == "while":
            trips = mod._infer_trip_count(ins, comp) or 1.0
            total += trips * dot_flops(mod, mod._called(ins, "body"))
        else:
            callee = mod._called(ins, "calls") or mod._called(ins, "to_apply")
            if callee and callee in mod.computations:
                total += dot_flops(mod, callee)
    return total


out, meta = {{}}, {{}}
with mesh:
    for name, mod in WORKLOADS.items():
        args = mod.make_args(sizes[name])
        if name == "aes":
            plain, key, rk, sb = args
            oracle = mod.reference(plain, key)
            jargs = (jnp.asarray(plain), jnp.asarray(rk), jnp.asarray(sb))
        else:
            oracle = mod.reference(*args)
            jargs = tuple(jnp.asarray(a) for a in args)
        for mode, mk in [("umode", mod.make_umode), ("dmode", mod.make_dmode)]:
            fn = mk(mesh)
            out[name + "_" + mode] = np.asarray(fn(*jargs))
            rep = evaluate(name, mod.PATTERN, mode, fn, jargs, oracle)
            text = fn.lower(*jargs).compile().as_text()
            cost = analyze(text)
            hmod = HloModule(text)
            meta[name + "_" + mode] = {{
                "correct": rep.correct, "bytes": rep.collective_bytes,
                "by_kind": rep.bytes_by_kind,
                "records": [[c.kind, c.payload_bytes, c.groups, c.count]
                            for c in cost.collectives],
                "collective_sim_time": collective_sim_time(cost, spec),
                "dot_flops": dot_flops(hmod, hmod.entry)}}
np.savez({path!r}, **out)
print("META", json.dumps(meta))
"""


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("patterns") / "jax.npz")
    stdout = run_with_devices(M, _JAX_SCRIPT.format(
        m=M, sizes=json.dumps(SIZES), path=path), timeout=400)
    meta = json.loads(next(line for line in stdout.splitlines()
                           if line.startswith("META "))[5:])
    with np.load(path) as f:
        return {k: f[k] for k in f.files}, meta


@pytest.fixture(scope="module")
def port_side():
    """Every workload and mode through the port's ``evaluate`` on a
    4-shard CPU mesh: {name_mode: (report, output)}."""
    mesh = Mesh(["cpu"] * M)
    out = {}
    for name, mod in WORKLOADS.items():
        args, oracle = mgmark.workload_inputs(name, SIZES[name])
        for mode in ("umode", "dmode"):
            prog = getattr(mod, f"make_{mode}")(mesh)
            rep = evaluate(name, mod.PATTERN, mode, prog, args, oracle, mesh)
            out[f"{name}_{mode}"] = (rep, prog.gather(
                prog(*prog.place(*args))).numpy())
    return out


@pytest.mark.parametrize("mode", ["umode", "dmode"])
@pytest.mark.parametrize("name", list(WORKLOADS))
def test_output_matches_jax(jax_side, port_side, name, mode):
    rep, got = port_side[f"{name}_{mode}"]
    want = jax_side[0][f"{name}_{mode}"]
    assert rep.correct and jax_side[1][f"{name}_{mode}"]["correct"]
    assert got.dtype == want.dtype and got.shape == want.shape
    if name in EXACT:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=FLOAT_ATOL, rtol=0)


@pytest.mark.parametrize("name", list(WORKLOADS))
def test_dmode_bytes_match_jax(jax_side, port_side, name):
    rep = port_side[f"{name}_dmode"][0]
    want = jax_side[1][f"{name}_dmode"]
    assert rep.collective_bytes == want["bytes"] == DMODE_BYTES[name]
    assert rep.bytes_by_kind == want["by_kind"]


@pytest.mark.parametrize("name", list(WORKLOADS))
def test_umode_traffic_is_not_a_reading(port_side, name):
    """U-mode's bytes are no reading of the run (the global program on one
    device moves nothing between shards): they are the collectives of its
    DTensor trace, pinned here; on the CPU no kernel launches and no
    device time is taken."""
    rep = port_side[f"{name}_umode"][0]
    assert rep.bytes_by_kind == rep.cost.collective_bytes_by_kind() \
        == UMODE_BYTES[name]
    assert rep.collective_bytes == sum(UMODE_BYTES[name].values())
    assert rep.device_ms is None
    assert rep.device == "cpu" and not any(rep.launches.values())


@pytest.mark.parametrize("name", list(WORKLOADS))
def test_umode_bytes_against_the_reference(jax_side, port_side, name):
    """Equal to GSPMD's where the traffic is a reduction or a transpose;
    elsewhere the port's DTensor bytes differ from GSPMD's (halos by
    collective-permute, a sort gathered a stage at a time), and both
    stand pinned."""
    rep = port_side[f"{name}_umode"][0]
    want = jax_side[1][f"{name}_umode"]
    if name in UMODE_AS_REFERENCE:
        assert rep.collective_bytes == want["bytes"]
        assert rep.bytes_by_kind == want["by_kind"]
    else:
        assert rep.collective_bytes != want["bytes"]
    assert all(g == [list(range(M))] for c in rep.cost.collectives
               for g in [c.groups])


@pytest.mark.parametrize("name", list(WORKLOADS))
def test_dmode_trace_records_match_the_reference_hlo(jax_side, port_side,
                                                      name):
    """The traced D-mode program's collectives: bytes by kind equal the
    reference's HLO count and the counted bytes, every group the whole
    mesh, and the analytic collective time equal to the reference's."""
    rep = port_side[f"{name}_dmode"][0]
    want = jax_side[1][f"{name}_dmode"]
    cost = rep.cost
    assert cost.collective_bytes_by_kind() == want["by_kind"] \
        == rep.bytes_by_kind
    assert cost.collective_bytes == DMODE_BYTES[name]
    assert all(c.groups == [list(range(M))] for c in cost.collectives)
    assert all(r[2] == [list(range(M))] for r in want["records"])
    spec = SystemSpec(pod_shape=(1, M))
    assert collective_sim_time(cost, spec) == want["collective_sim_time"]


@pytest.mark.parametrize("mode", ["umode", "dmode"])
@pytest.mark.parametrize("name", ["gd", "km", "mt"])
def test_matmul_flops_equal_the_reference(jax_side, port_side, name, mode):
    """The traced matrix products of one device equal the dots of the
    reference's per-device HLO (mt has none)."""
    rep = port_side[f"{name}_{mode}"][0]
    assert hlo.matmul_flops(rep.cost) == \
        jax_side[1][f"{name}_{mode}"]["dot_flops"]


@pytest.mark.parametrize("name", list(WORKLOADS))
def test_every_shard_runs_the_same_program(port_side, name):
    """The SPMD check: every shard's trace of the D-mode program (op
    names, FLOPs, bytes, collectives) is shard 0's, which is the trace
    simulated; only constants made from host data (AES's ShiftRows
    index, KM's one-hot iota: one op a shard) belong to no shard."""
    cost = port_side[f"{name}_dmode"][0].cost
    assert sorted(cost.shards) == list(range(M))
    assert hlo.asymmetric_shards(cost) == []
    assert cost.trace == cost.shards[0]
    assert len(cost.unattributed) == {"aes": M, "km": M}.get(name, 0)


@pytest.mark.parametrize("mode", ["umode", "dmode"])
@pytest.mark.parametrize("name", list(WORKLOADS))
def test_simulated_fields_are_filled(port_side, name, mode):
    rep = port_side[f"{name}_{mode}"][0]
    assert finite(rep) and rep.sim_time_s > 0 and 0 <= rep.compute_util <= 1
    assert rep.flops == rep.cost.flops and rep.hbm_bytes == rep.cost.hbm_bytes


@pytest.mark.parametrize("mode", ["umode", "dmode"])
@pytest.mark.parametrize("name", ["sc", "bs"])
def test_traced_kernel_ops_are_one_device_s_launches(name, mode):
    """The kernels on the trace: U-mode's program makes the card's launch
    plan once, D-mode's each shard its own (chip_smoke.py holds these to
    the launch counters)."""
    cost = trace(getattr(WORKLOADS[name], f"make_{mode}")(Mesh(["cpu"] * M)),
                 mgmark.workload_inputs(name, SIZES[name])[0])
    kernels = hlo.kernel_ops(cost.trace)
    if name == "sc":
        assert kernels == {"stencil2d": 1}
        return
    L = SIZES["bs"] // (M if mode == "dmode" else 1)
    tile = min(bs.BLOCK, L)
    steps = [st for st in bs._steps(SIZES["bs"], tile)
             if mode == "umode" or st[0] == "block" or st[2] < L]
    want = {}
    for st in steps:
        k = "bitonic_block" if st[0] == "block" else "bitonic_stage"
        want[k] = want.get(k, 0) + 1
    assert kernels == want


@pytest.mark.parametrize("name", list(WORKLOADS))
def test_umode_bytes_at_the_default_size(name):
    """chip_smoke.py's MGMARK_UMODE_BYTES: U-mode traced on meta at
    default_size(4) (nothing runs)."""
    mod = WORKLOADS[name]
    args, _ = mgmark.workload_inputs(name, mod.default_size(M))
    cost = trace(mod.make_umode(Mesh(["cpu"] * M)), args)
    assert cost.collective_bytes == UMODE_BYTES_DEFAULT[name]


def test_no_process_group_is_left_after_evaluate(port_side):
    import torch.distributed as dist
    assert not dist.is_initialized()
    mesh = Mesh(["cpu"] * M)
    args, oracle = mgmark.workload_inputs("mt", 8)
    evaluate("mt", "scatter", "umode", WORKLOADS["mt"].make_umode(mesh),
             args, oracle, mesh)
    assert not dist.is_initialized()


def test_a_traced_program_that_is_not_spmd_raises():
    """A D-mode program whose shards run different ops cannot stand for
    every device: ``trace`` refuses it."""
    from repro_torch.patterns.mesh import DEV, shard_map
    mesh = Mesh(["cpu"] * M)
    prog = shard_map(lambda xs: [x * 2 if i == 0 else x for i, x in
                                 enumerate(xs)], mesh, (DEV,), DEV)
    with pytest.raises(ValueError, match=r"shards \[1, 2, 3\]"):
        trace(prog, [np.zeros(8, np.float32)])


@pytest.mark.parametrize("name", list(WORKLOADS))
def test_make_args_and_oracle_bit_equal_to_jax(name):
    got = WORKLOADS[name].make_args(SIZES[name], seed=3)
    want = JWORKLOADS[name].make_args(SIZES[name], seed=3)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    args = got[:2] if name == "aes" else got
    g, w = (np.asarray(mod.reference(*args))
            for mod in (WORKLOADS[name], JWORKLOADS[name]))
    if name in EXACT:
        np.testing.assert_array_equal(g, w)
    else:
        np.testing.assert_allclose(g, w, atol=FLOAT_ATOL, rtol=0)


def test_aes_fips_197_vector():
    """FIPS-197 appendix C.3 AES-256 known answer, through the port's
    tensor cipher."""
    key = np.arange(32, dtype=np.uint8)
    pt = np.frombuffer(bytes.fromhex("00112233445566778899aabbccddeeff"),
                       np.uint8).copy()
    ct = aes.encrypt_blocks(torch.from_numpy(pt[None]),
                            torch.from_numpy(aes.expand_key(key)),
                            torch.from_numpy(aes.sbox()))
    assert ct.numpy().tobytes() == bytes.fromhex(
        "8ea2b7ca516745bfeafc49904b496089")


@pytest.mark.parametrize("shards", [2, 8])
@pytest.mark.parametrize("name", ["sc", "bs"])
def test_dmode_on_other_mesh_sizes(name, shards):
    mod = WORKLOADS[name]
    mesh = Mesh(["cpu"] * shards)
    args, oracle = mgmark.workload_inputs(name, SIZES[name])
    rep = evaluate(name, mod.PATTERN, "dmode", mod.make_dmode(mesh), args,
                   oracle, mesh)
    assert rep.correct and rep.max_err <= FLOAT_ATOL
    if name == "sc":                    # two halo rows of 128 f32
        assert rep.bytes_by_kind == {"collective-permute": 2 * 128 * 4}
    else:                               # cross-shard stages of Ll f32
        k = shards.bit_length() - 1
        stages = k * (k + 1) // 2
        assert rep.bytes_by_kind == {
            "collective-permute": stages * SIZES["bs"] // shards * 4}


def test_evaluate_refuses_an_unknown_mode():
    mesh = Mesh(["cpu"] * M)
    with pytest.raises(ValueError, match="mode"):
        evaluate("mt", "scatter", "gspmd", WORKLOADS["mt"].make_umode(mesh),
                 (np.zeros((4, 4), np.float32),), np.zeros((4, 4)), mesh)


def test_launcher_on_the_cpu(capsys):
    assert mgmark.main(["--device", "cpu", "--size", "256"]) == 0
    rows = capsys.readouterr().out.splitlines()
    assert len(rows) == 2 * len(WORKLOADS) + 1
    assert all("ok=True" in r and "not measured" in r
               and "(simulated)" in r for r in rows[:-1])
    assert rows[-1] == "# all outputs match oracles: True"


def test_launcher_validates_on_the_cpu(capsys):
    """--validate: each D-mode run's simulated time over the reference's
    bound (at least the bound: the simulator adds launch overheads and
    serialisation), then the four lessons."""
    assert mgmark.main(["--device", "cpu", "--size", "256",
                        "--validate"]) == 0
    out = capsys.readouterr().out.splitlines()
    ratios = [line for line in out if ", ratio " in line]
    assert [r.split()[0] for r in ratios] == list(WORKLOADS)
    assert all(float(r.rsplit(" ", 1)[1]) >= 1.0 for r in ratios)
    assert sum(line.startswith("# 1. ") or line.startswith("# 2. ")
               or line.startswith("# 3. ") or line.startswith("# 4. ")
               for line in out) == 4
    assert out[-1] == "# all outputs match oracles: True"


def test_lessons_on_the_port_s_numbers(port_side):
    reports = [port_side[f"{n}_{m}"][0] for n in WORKLOADS
               for m in ("umode", "dmode")]
    lines = mgmark.lessons(reports)
    assert lines[0] == "1. partitioned => zero traffic: AES D-mode 0 B"
    assert lines[1] == ("2. explicit placement saves traffic on: "
                        "['fir', 'sc', 'bs']")
    assert not math.isnan(float(lines[2].split("= ")[1].split()[0]))


def test_pattern_study_torch_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples",
                                      "pattern_study_torch.py"),
         "--device", "cpu"], env=env, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    rows = [line for line in lines[1:] if line.split()[:1] and
            line.split()[0] in WORKLOADS]
    assert len(rows) == 2 * len(WORKLOADS)
    assert all(" yes " in r and r.rstrip().endswith("-") for r in rows)
    assert sum(line.strip()[:2] in ("1.", "2.", "3.", "4.")
               for line in lines) == 4


def test_launcher_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: --device cuda is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        mgmark.main(["--workloads", "mt", "--size", "8"])


def test_cpu_mesh_launches_no_kernel():
    """On the CPU the wrappers run the plain versions; no counter moves."""
    before = ops.launch_counts()
    mesh = Mesh(["cpu"] * M)
    mgmark.run_suite(mesh, ["sc", "bs"], {"sc": 16, "bs": 64})
    assert ops.launch_counts() == before
