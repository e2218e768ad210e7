"""repro_torch.patterns.mesh: the shard mesh's collectives vs JAX's
``shard_map`` collectives on 4 fake XLA CPU devices, and their byte
counts and traced records (``repro_torch.core.hlo.analyze`` on meta
shards) vs the reference's HLO parser (``repro.core.analyze``).

The JAX side runs once for the file, in one subprocess with 4 devices
(``conftest.run_with_devices``), and writes an ``.npz`` the tests read.
Every comparison is exact: collectives only move values, and psum adds
small integers, which f32 sums exactly in any order."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_mkl import init_vml  # noqa: E402

init_vml()      # before any test: tests/_torch_mkl.py says why

from conftest import run_with_devices  # noqa: E402
from repro_torch.core import hlo  # noqa: E402
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
                  "by_kind": cost.collective_bytes_by_kind(),
                  "records": [[c.kind, c.payload_bytes, c.operand_bytes,
                               c.output_bytes, c.groups, c.count]
                              for c in cost.collectives]}}
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


def _prog(mesh, name):
    kind, kw = CASES[name]

    def local(xs):
        if kind == "all_to_all" and kw["split_axis"] == 2:
            xs = [x.reshape(x.shape[0], x.shape[1], M, -1) for x in xs]
        return getattr(mesh, kind)(xs, **kw)
    return shard_map(local, mesh, in_specs=(DEV,), out_specs=DEV)


def _run(mesh, name):
    prog = _prog(mesh, name)
    mesh.reset_bytes()
    return prog.gather(prog(*prog.place(_input())))


def _trace(mesh, name):
    """The collective's program traced on meta shards (placed by the
    mesh, which tags them), with the counter read around it."""
    prog = _prog(mesh, name)
    placed = prog.place(torch.empty(SHAPE, device="meta"))
    mesh.reset_bytes()
    return hlo.analyze(prog, *placed)


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


@pytest.mark.parametrize("name", sorted(CASES))
def test_traced_records_match_the_reference_hlo(jax_side, name):
    """One ``CollectiveRecord`` a collective, as the reference's parser
    writes it: kind, payload (operand bytes), operand and output bytes,
    groups (a permute's pairs' members as one group), count."""
    cost = _trace(Mesh(["cpu"] * M), name)
    got = [[c.kind, c.payload_bytes, c.operand_bytes, c.output_bytes,
            c.groups, c.count] for c in cost.collectives]
    assert got == jax_side[1][name]["records"]
    assert [op.kind for op in cost.trace] == ["collective"] * len(got)
    assert all(ops == cost.trace for ops in cost.shards.values())


@pytest.mark.parametrize("name", sorted(CASES))
def test_counter_reads_the_same_bytes_traced_or_not(name):
    mesh = Mesh(["cpu"] * M)
    _run(mesh, name)
    run = dict(mesh.bytes_by_kind)
    cost = _trace(mesh, name)
    assert mesh.bytes_by_kind == run == cost.collective_bytes_by_kind()


def test_psum_of_several_lists_is_one_all_reduce():
    """As XLA combines KM's two psums: one record of both operands' bytes,
    each list summed on its own."""
    mesh = Mesh(["cpu"] * M)
    xs = [torch.full((2, 3), float(i)) for i in range(M)]
    ys = [torch.full((5,), float(i), dtype=torch.float64) for i in range(M)]
    sx, sy = mesh.psum(xs, ys)
    assert sx[2].tolist() == [[6.0] * 3] * 2 and sy[0].tolist() == [6.0] * 5
    assert mesh.bytes_by_kind == {"all-reduce": 24.0 + 40.0}
    placed = [mesh.put(torch.empty(8, 3, device="meta"), DEV),
              mesh.put(torch.empty(20, dtype=torch.float64, device="meta"),
                       DEV)]
    cost = hlo.analyze(mesh.psum, *placed)
    assert [(c.kind, c.payload_bytes) for c in cost.collectives] == \
        [("all-reduce", 24 + 40)]


def test_an_op_that_mixes_shards_raises():
    mesh = Mesh(["cpu"] * M)
    xs = mesh.put(torch.empty(8, device="meta"), DEV)
    with pytest.raises(ValueError, match=r"shards \[0, 1\]"):
        hlo.analyze(lambda xs: xs[0] + xs[1], xs)


def test_constants_from_host_data_belong_to_no_shard():
    """An op with no shard's operand (a table copied from the host) is on
    no device's trace; it is counted in ``unattributed``."""
    mesh = Mesh(["cpu"] * M)
    xs = mesh.put(torch.empty(8, device="meta"), DEV)
    cost = hlo.analyze(lambda xs: [x + torch.as_tensor(
        np.arange(2.0, dtype=np.float32), device="meta").sum() for x in xs],
        xs)
    assert len(cost.unattributed) == 2 * M       # the copy and its sum
    assert [op.name for op in cost.trace] == ["aten.add.Tensor"]
    assert hlo.asymmetric_shards(cost) == []


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
