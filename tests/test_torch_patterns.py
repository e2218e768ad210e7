"""repro_torch MGMark: every workload in U-mode and D-mode on a 4-shard
CPU mesh vs the JAX package's ``make_umode`` / ``make_dmode`` on 4 fake
XLA CPU devices, at tests/test_patterns.py's sizes; D-mode collective
bytes vs the reference's HLO count; ``make_args`` bit-equal; SC and BS
D-mode on other mesh sizes; the launcher on the CPU.

The JAX side runs once for the file, in one subprocess with 4 devices
(``conftest.run_with_devices``), and writes an ``.npz`` the tests read.
Tolerance: AES, MT and BS only move or xor values and must be equal; the
float workloads agree within 1e-5 (f32 sums in another order)."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import run_with_devices  # noqa: E402
from repro.patterns import WORKLOADS as JWORKLOADS  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import mgmark  # noqa: E402
from repro_torch.patterns import WORKLOADS, Mesh, aes, evaluate  # noqa: E402

M = 4
SIZES = {"aes": 8192, "km": 2048, "fir": 8192, "sc": 128, "gd": 2048,
         "mt": 128, "bs": 2048}
# the reference's D-mode bytes per device at SIZES (its HLO count)
DMODE_BYTES = {"aes": 0, "km": 2112, "fir": 60, "sc": 1024, "gd": 8192,
               "mt": 16384, "bs": 6144}
EXACT = ("aes", "mt", "bs")
FLOAT_ATOL = 1e-5

_JAX_SCRIPT = """
import json
import numpy as np
import jax.numpy as jnp
from repro.patterns import WORKLOADS, evaluate
mesh = make_auto_mesh(({m},), ("dev",))
sizes = json.loads({sizes!r})
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
            meta[name + "_" + mode] = {{
                "correct": rep.correct, "bytes": rep.collective_bytes,
                "by_kind": rep.bytes_by_kind}}
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
    """U-mode moves nothing between shards: its bytes are None, not 0;
    the cost fields wait for the cost front end; on the CPU no kernel
    launches and no device time is taken."""
    rep = port_side[f"{name}_umode"][0]
    assert rep.collective_bytes is None and rep.bytes_by_kind is None
    assert rep.sim_time_s is None and rep.device_ms is None
    assert rep.device == "cpu" and not any(rep.launches.values())


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
    assert all("ok=True" in r and "not measured" in r for r in rows[:-1])
    assert rows[-1] == "# all outputs match oracles: True"


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
