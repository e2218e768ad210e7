"""repro_torch bitonic_stage and bitonic_block: the plain versions vs the
JAX package's Pallas kernel (interpret mode on the CPU) and its oracles,
the ``offset`` the port adds, the wrappers' TPU-API checks, and how BS's
sort groups its stages into launches.  The CUDA kernel itself
is tested on the card by tests/test_torch_cuda.py.

Every comparison is exact: a stage only moves values."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_mkl import init_vml  # noqa: E402

init_vml()      # before any test: tests/_torch_mkl.py says why

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import bitonic as bitonic_kernel  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.patterns import bs  # noqa: E402


def _rand(n, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    if dtype == np.int32:
        return rng.integers(-1000, 1000, n, dtype=np.int32)
    return rng.standard_normal(n).astype(dtype)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# tests/test_kernels.py::test_bitonic_stage_matches_ref's pairs
@pytest.mark.parametrize("size,dist", [(2, 1), (8, 4), (64, 16),
                                       (2048, 256)])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_stage_matches_jax_kernel(size, dist, dtype):
    x = _rand(2048, 31, dtype)
    want = np.asarray(jops.bitonic_stage(jnp.asarray(x), dist, size,
                                         block=512))
    np.testing.assert_array_equal(
        ops.bitonic_stage(_t(x), dist, size, block=512).numpy(), want)
    np.testing.assert_array_equal(
        ref.bitonic_stage_ref(_t(x), dist, size).numpy(), want)


@pytest.mark.parametrize("size,dist", [(4, 2), (512, 128), (1024, 64),
                                       (2048, 1), (4096, 256)])
def test_offset_stage_is_the_global_stage_sliced(size, dist):
    """A shard's stage with offset = shard * Ll equals the reference's
    global stage on that shard's slice, including size > Ll, where the
    direction is a bit of the shard index."""
    L, m = 4096, 4
    Ll = L // m
    x = _rand(L, 42)
    want = np.asarray(jref.bitonic_stage_ref(jnp.asarray(x), dist, size))
    for s in range(m):
        got = ops.bitonic_stage(_t(x[s * Ll:(s + 1) * Ll]), dist, size,
                                block=512 if dist < 512 else Ll,
                                offset=s * Ll)
        np.testing.assert_array_equal(got.numpy(),
                                      want[s * Ll:(s + 1) * Ll])


def test_offset_zero_is_the_reference_stage():
    x = _rand(256, 43)
    for size, dist in [(2, 1), (16, 8), (256, 32)]:
        np.testing.assert_array_equal(
            ref.bitonic_stage_ref(_t(x), dist, size, offset=0).numpy(),
            np.asarray(jref.bitonic_stage_ref(jnp.asarray(x), dist, size)))


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("L", [2, 256, 4096])
def test_sort_ref_is_np_sort_and_jax_sort(seed, L):
    x = _rand(L, seed)
    got = ref.bitonic_sort_ref(_t(x)).numpy()
    np.testing.assert_array_equal(got, np.sort(x))
    np.testing.assert_array_equal(
        got, np.asarray(jref.bitonic_sort_ref(jnp.asarray(x))))


def test_sort_ref_int32():
    x = _rand(1024, 44, np.int32)
    np.testing.assert_array_equal(ref.bitonic_sort_ref(_t(x)).numpy(),
                                  np.sort(x))


def test_wrapper_runs_the_plain_version_on_cpu():
    x = _t(_rand(1024, 45))
    n = ops.bitonic_stage.launches
    got = ops.bitonic_stage(x, 4, 16)
    assert ops.bitonic_stage.launches == n
    torch.testing.assert_close(got, ref.bitonic_stage_ref(x, 4, 16),
                               rtol=0, atol=0)


@pytest.mark.parametrize("L,dist,block", [
    (2048, 512, 512),      # dist >= block
    (2048, 2048, 4096),    # block cut to L = dist
    (3000, 4, 2048),       # L % block != 0
    (2048, 3, 6),          # not a power of two (block % (2*dist) holds)
    (2048, 0, 2048),       # dist < 1
])
def test_wrapper_keeps_the_tpu_checks(L, dist, block):
    with pytest.raises(ValueError, match="bitonic_stage"):
        ops.bitonic_stage(_t(_rand(L, 46)), dist, 2 * dist or 2, block=block)


def test_block_is_cut_to_the_length():
    """block > L is cut to L, as the TPU wrapper does."""
    x = _rand(64, 47)
    want = np.asarray(jops.bitonic_stage(jnp.asarray(x), 16, 32, block=2048))
    np.testing.assert_array_equal(
        ops.bitonic_stage(_t(x), 16, 32, block=2048).numpy(), want)


def test_launcher_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        bitonic_kernel.bitonic_stage(_t(_rand(64, 48)), 1, 2)


# ---------------------------------------------------------------------------
# bitonic_block: runs of in-tile stages in one launch
# ---------------------------------------------------------------------------

def _jax_stages(x, stages, block):
    """The composition of the JAX Pallas stage (interpret mode)."""
    y = jnp.asarray(x)
    for size, dist in stages:
        y = jops.bitonic_stage(y, dist, size, block=block)
    return np.asarray(y)


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("L,size,tile", [
    (512, 64, 64),      # a sort's first launch: every stage of 2..tile
    (512, 512, 64),     # a later phase's tail: dist tile/2 .. 1
    (256, 128, 64),
    (256, 16, 64)])     # phases 2..16 only
def test_block_matches_jax_kernel_composition(dtype, L, size, tile):
    x = _rand(L, 60, dtype)
    stages = ref.bitonic_block_stages(size, tile)
    want = _jax_stages(x, stages, tile)
    np.testing.assert_array_equal(
        ref.bitonic_block_ref(_t(x), size, tile).numpy(), want)
    np.testing.assert_array_equal(
        ops.bitonic_block(_t(x), size, block=tile).numpy(), want)


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("size", [256, 512, 1024])
def test_block_with_offset_is_the_global_stages_sliced(dtype, size):
    """A shard's block launch with offset = shard * Ll equals the JAX
    stages on the whole array, sliced, also where size > Ll."""
    L, m, tile = 1024, 4, 64
    Ll = L // m
    x = _rand(L, 61, dtype)
    want = _jax_stages(x, ref.bitonic_block_stages(size, tile), tile)
    for s in range(m):
        got = ops.bitonic_block(_t(x[s * Ll:(s + 1) * Ll]), size, block=tile,
                                offset=s * Ll)
        np.testing.assert_array_equal(got.numpy(), want[s * Ll:(s + 1) * Ll])


def test_block_stages():
    assert ref.bitonic_block_stages(8, 2048) == [
        (2, 1), (4, 2), (4, 1), (8, 4), (8, 2), (8, 1)]
    assert ref.bitonic_block_stages(4096, 8) == [(4096, 4), (4096, 2),
                                                 (4096, 1)]
    assert len(ref.bitonic_block_stages(2048, 2048)) == 66


@pytest.mark.parametrize("L,size,offset", [
    (3000, 2048, 0),       # block (cut to L) is no power of two
    (2048, 3, 0), (2048, 1, 0), (2048, 6, 0),   # size no power of two >= 2
    (2048, 2048, 1024)])   # offset no multiple of the block
def test_block_wrapper_checks(L, size, offset):
    """block must be a power of two dividing L and offset, size a power of
    two >= 2."""
    with pytest.raises(ValueError, match="bitonic_block"):
        ops.bitonic_block(_t(_rand(L, 62)), size, offset=offset)


def test_block_launcher_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        bitonic_kernel.bitonic_block(_t(_rand(64, 63)), 64, 64)


@pytest.mark.parametrize("L,tile,stages,blocks", [
    (131072, 2048, 21, 7),       # BS U-mode at default_size(4)
    (32768, 2048, 10, 5),
    (2048, 2048, 0, 1), (256, 256, 0, 1), (2, 2, 0, 1), (1, 1, 0, 0)])
def test_sort_steps_expand_to_the_stages(L, tile, stages, blocks):
    """The launches of a sort, each block launch expanded into its stages,
    are every stage of the sort in order."""
    steps = list(bs._steps(L, tile))
    expanded = []
    for step in steps:
        expanded += (ref.bitonic_block_stages(step[1], tile)
                     if step[0] == "block" else [step[1:]])
    assert expanded == list(bs._stages(L))
    assert sum(s[0] == "stage" for s in steps) == stages
    assert sum(s[0] == "block" for s in steps) == blocks


def test_dmode_launches_per_shard():
    """BS D-mode at default_size(4): per shard of 32768, 3 cross-shard
    stages, 18 stage launches with 2048 <= dist < 32768 and 7 block
    launches (72 + 28 over four shards)."""
    L, m = bs.default_size(4), 4
    Ll = L // m
    steps = list(bs._steps(L, min(bs.BLOCK, Ll)))
    cross = [s for s in steps if s[0] == "stage" and s[2] >= Ll]
    local = [s for s in steps if s[0] == "stage" and s[2] < Ll]
    assert (len(cross), len(local), len(steps) - len(cross) - len(local)) \
        == (3, 18, 7)


@pytest.mark.parametrize("L", [2, 64, 4096, 8192])
def test_sort_matches_np_sort(L):
    x = _rand(L, 64)
    np.testing.assert_array_equal(bs.sort(_t(x)).numpy(), np.sort(x))
