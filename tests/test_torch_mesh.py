"""repro_torch.patterns.mesh: the shard mesh's collectives vs JAX's
``shard_map`` collectives on 4 fake XLA CPU devices, and their byte
counts vs the reference's HLO parser (``repro.core.analyze``).

The JAX side runs once for the file, in one subprocess with 4 devices
(``conftest.run_with_devices``), and writes an ``.npz`` the tests read.
Every comparison is exact: collectives only move values, and psum adds
small integers, which f32 sums exactly in any order."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import run_with_devices  # noqa: E402
from repro_torch.patterns.mesh import DEV, Mesh, shard_map  # noqa: E402

M = 4
# name -> (collective, keyword arguments)
CASES = {
    "ppermute_ring": ("ppermute", {"perm": [(i, (i + 1) % M)
                                            for i in range(M)]}),
    "ppermute_partial": ("ppermute", {"perm": [(0, 1), (1, 2)]}),
    "ppermute_swap": ("ppermute", {"perm": [(0, 3), (3, 0), (1, 2),
                                            (2, 1)]}),
    "psum": ("psum", {}),
    "all_to_all_0_0": ("all_to_all", {"split_axis": 0, "concat_axis": 0}),
    "all_to_all_0_1": ("all_to_all", {"split_axis": 0, "concat_axis": 1}),
    "all_to_all_2_0": ("all_to_all", {"split_axis": 2, "concat_axis": 0}),
}
# each shard is (M, 3, 8): dimension 0 is the M pieces of all_to_all;
# the split_axis=2 case views it as (M, 3, M, 2)
SHAPE = (M * M, 3, 8)


def _input():
    # small integers: psum is exact in f32 whatever the order
    return np.random.default_rng(0).integers(-50, 50, SHAPE).astype(
        np.float32)


_JAX_SCRIPT = """
import json
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.compat import shard_map
from repro.core import analyze
mesh = make_auto_mesh(({m},), ("dev",))
cases = json.loads({cases!r})
x = jnp.asarray(np.random.default_rng(0).integers(-50, 50, {shape}).astype(
    np.float32))
out, meta = {{}}, {{}}
for name, (kind, kw) in cases.items():
    if kind == "ppermute":
        local = lambda v, kw=kw: jax.lax.ppermute(
            v, "dev", perm=[tuple(p) for p in kw["perm"]])
    elif kind == "psum":
        local = lambda v: jax.lax.psum(v, "dev")
    else:
        def local(v, kw=kw):
            if kw["split_axis"] == 2:
                v = v.reshape(v.shape[0], v.shape[1], {m}, -1)
            return jax.lax.all_to_all(v, "dev", kw["split_axis"],
                                      kw["concat_axis"], tiled=False)
    fn = jax.jit(shard_map(local, mesh=mesh, in_specs=(P("dev"),),
                           out_specs=P("dev"), check_vma=False))
    compiled = fn.lower(x).compile()
    out[name] = np.asarray(compiled(x))
    cost = analyze(compiled.as_text())
    meta[name] = {{"bytes": cost.collective_bytes,
                  "by_kind": cost.collective_bytes_by_kind()}}
np.savez({path!r}, **out)
print("META", json.dumps(meta))
"""


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mesh") / "jax.npz")
    stdout = run_with_devices(M, _JAX_SCRIPT.format(
        m=M, cases=json.dumps(CASES), shape=SHAPE, path=path), timeout=300)
    meta = json.loads(next(line for line in stdout.splitlines()
                           if line.startswith("META "))[5:])
    with np.load(path) as f:
        return {k: f[k] for k in f.files}, meta


def _run(mesh, name):
    kind, kw = CASES[name]

    def local(xs):
        if kind == "all_to_all" and kw["split_axis"] == 2:
            xs = [x.reshape(x.shape[0], x.shape[1], M, -1) for x in xs]
        return getattr(mesh, kind)(xs, **kw)
    prog = shard_map(local, mesh, in_specs=(DEV,), out_specs=DEV)
    mesh.reset_bytes()
    return prog.gather(prog(*prog.place(_input())))


@pytest.mark.parametrize("name", sorted(CASES))
def test_collective_matches_shard_map(jax_side, name):
    mesh = Mesh(["cpu"] * M)
    got = _run(mesh, name)
    np.testing.assert_array_equal(got.numpy(), jax_side[0][name])


@pytest.mark.parametrize("name", sorted(CASES))
def test_bytes_match_the_reference_hlo_count(jax_side, name):
    """Per-device payload bytes, by kind, as core/hlo.py counts them."""
    mesh = Mesh(["cpu"] * M)
    _run(mesh, name)
    want = jax_side[1][name]
    assert mesh.collective_bytes == want["bytes"]
    assert mesh.bytes_by_kind == want["by_kind"]


def test_partial_permute_sends_zeros_to_untargeted_shards():
    mesh = Mesh(["cpu"] * M)
    xs = [torch.full((2,), float(i + 1)) for i in range(M)]
    out = mesh.ppermute(xs, [(0, 1), (1, 2)])
    assert [o.tolist() for o in out] == [[0, 0], [1, 1], [2, 2], [0, 0]]


def test_collectives_copy_and_never_alias():
    mesh = Mesh(["cpu"] * M)
    xs = [torch.arange(4.0) + i for i in range(M)]
    keep = [x.clone() for x in xs]
    outs = [mesh.ppermute(xs, [(i, i) for i in range(M)]), mesh.psum(xs),
            mesh.all_to_all([x.reshape(M, 1) for x in xs])]
    ptrs = {x.data_ptr() for x in xs}
    for out in outs:
        assert len({o.data_ptr() for o in out}) == M     # one per shard
        assert not ptrs & {o.data_ptr() for o in out}
        for o in out:
            o.add_(100)
    for x, k in zip(xs, keep):
        torch.testing.assert_close(x, k, rtol=0, atol=0)


def test_bytes_accumulate_by_kind_and_reset():
    mesh = Mesh(["cpu"] * M)
    xs = [torch.zeros(3, 5) for _ in range(M)]            # 60 bytes each
    mesh.ppermute(xs, [(0, 1)])
    mesh.ppermute(xs, [(1, 0)])
    mesh.psum(xs)
    mesh.all_to_all([torch.zeros(M, 2, dtype=torch.int32)] * M)
    assert mesh.bytes_by_kind == {"collective-permute": 120.0,
                                  "all-reduce": 60.0, "all-to-all": 32.0}
    assert mesh.collective_bytes == 212.0
    mesh.reset_bytes()
    assert mesh.collective_bytes == 0 and mesh.bytes_by_kind == {}


def test_shard_unshard_round_trip_and_replicated_output():
    mesh = Mesh(["cpu"] * M)
    x = torch.arange(24.0).reshape(8, 3)
    xs = mesh.put(x, DEV)
    assert [tuple(s.shape) for s in xs] == [(2, 3)] * M
    torch.testing.assert_close(mesh.unshard(xs, DEV), x, rtol=0, atol=0)
    reps = mesh.put(x, None)
    assert all(r.data_ptr() != x.data_ptr() for r in reps)
    assert mesh.unshard(reps, None) is reps[0]


@pytest.mark.parametrize("bad", [
    lambda m: m.shard(torch.zeros(6)),                       # 6 % 4
    lambda m: m.ppermute([torch.zeros(2)] * M, [(0, 1), (2, 1)]),
    lambda m: m.psum([torch.zeros(2)] * (M - 1)),
    lambda m: m.psum([torch.zeros(2)] * (M - 1) + [torch.zeros(3)]),
    lambda m: m.all_to_all([torch.zeros(3, 2)] * M),         # dim 0 != M
])
def test_malformed_collectives_raise(bad):
    with pytest.raises(ValueError):
        bad(Mesh(["cpu"] * M))
