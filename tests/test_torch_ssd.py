"""repro_torch SSD: the plain versions and the chunked wrapper vs the JAX
package's Pallas kernel (interpret mode on the CPU), its oracle, its
chunked SSD and a literal sequential recurrence.  The CUDA kernel itself
is tested on the card by tests/test_torch_cuda.py.

Tolerances are tests/test_kernels.py's: atol/rtol 1e-4 for the
intra-chunk kernel, 1e-3 for the whole chunked SSD (exponentials of
cumulative sums, taken in another order)."""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_mkl import init_vml  # noqa: E402

init_vml()      # before any test: tests/_torch_mkl.py says why

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import ssd as ssd_kernel  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

KERNEL_TOL = dict(atol=1e-4, rtol=1e-4)
SSD_TOL = dict(atol=1e-3, rtol=1e-3)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _softplus(a):
    return np.logaddexp(a, 0.0).astype(np.float32)


def _chunk_inputs(R, H, Q, P, N, seed=0):
    """x, dt, cs, Bm, Cm as tests/test_kernels.py draws them."""
    x = _rand((R, H, Q, P), seed)
    dt = _softplus(_rand((R, H, Q), seed + 1))
    A = -np.exp(_rand((H,), seed + 2))
    cs = np.cumsum(dt * A[None, :, None], axis=-1).astype(np.float32)
    return (x, dt, cs, _rand((R, H, Q, N), seed + 3),
            _rand((R, H, Q, N), seed + 4))


def _ssd_inputs(B, L, H, P, N, seed=0):
    """x (B,L,H,P), dt (B,L,H) after softplus, A (H,), Bm/Cm (B,L,1,N)."""
    return (_rand((B, L, H, P), seed), _softplus(_rand((B, L, H), seed + 1)),
            -np.exp(_rand((H,), seed + 2)), _rand((B, L, 1, N), seed + 3),
            _rand((B, L, 1, N), seed + 4))


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


# ---------------------------------------------------------------------------
# intra-chunk kernel: plain version and wrapper
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("R,H,Q,P,N", [(2, 2, 64, 32, 16),
                                       (1, 4, 128, 64, 64),
                                       (3, 1, 32, 16, 8),
                                       (1, 4, 77, 16, 8),
                                       (1, 4, 1, 16, 8)])
def test_ssd_chunk_ref_matches_jax(R, H, Q, P, N):
    """tests/test_kernels.py::test_ssd_chunk_kernel's shapes, then a short
    last chunk (Q < 256, as the kernel takes it): the port's plain
    version against the Pallas kernel and against its oracle."""
    args = _chunk_inputs(R, H, Q, P, N)
    y, s = ref.ssd_chunk_ref(*_t(*args))
    assert y.dtype == s.dtype == torch.float32
    assert y.shape == (R, H, Q, P) and s.shape == (R, H, N, P)
    for jy, js in (jops.ssd_chunk_kernel(*_j(*args)),
                   jref.ssd_chunk_ref(*_j(*args))):
        _close(y, jy, KERNEL_TOL)
        _close(s, js, KERNEL_TOL)


def test_ssd_chunk_wrapper_runs_plain_version_on_cpu():
    """On CPU tensors the wrapper is the plain version, and takes B/C
    shared across heads through a head stride of 0."""
    x, dt, cs, Bm, Cm = _t(*_chunk_inputs(2, 4, 40, 16, 8, seed=6))
    Bm, Cm = (t[:, :1].expand(-1, 4, -1, -1) for t in (Bm, Cm))
    assert Bm.stride(1) == 0
    before = ops.launch_counts()
    got = ops.ssd_chunk_kernel(x, dt, cs, Bm, Cm)
    want = ref.ssd_chunk_ref(x, dt, cs, Bm.contiguous(), Cm.contiguous())
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert ops.launch_counts() == before       # no kernel was launched


_TESTS = pathlib.Path(__file__).resolve().parent


def test_ssd_chunk_ref_passes_in_fresh_processes():
    """The parametrisation that failed when it held its process's first
    VML call (tests/_torch_mkl.py), in 3 fresh pytest processes at once:
    all three pass."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(_TESTS.parent / "src"), os.environ.get("PYTHONPATH",
                                                               "")]))
    case = (f"{_TESTS / 'test_torch_ssd.py'}::"
            "test_ssd_chunk_ref_matches_jax[2-2-64-32-16]")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-p", "no:xdist", case], cwd=_TESTS.parent, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for _ in range(3)]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0 and "1 passed" in out, out[-3000:]


def test_port_tests_make_the_first_vml_call_on_one_thread():
    """Every CPU test file of the port calls init_vml right after it
    imports torch, before anything else of torch runs."""
    for path in sorted(_TESTS.glob("test_torch_*.py")):
        if path.name == "test_torch_cuda.py":      # card only
            continue
        lines = path.read_text().splitlines()
        at = lines.index('torch = pytest.importorskip("torch")')
        assert lines[at + 1] == "from _torch_mkl import init_vml  # noqa: E402"
        assert lines[at + 3].startswith("init_vml()"), path.name


def test_ssd_launcher_refuses_what_the_kernel_does_not_take():
    """The CUDA launcher raises before building or launching anything."""
    args = _t(*_chunk_inputs(1, 2, 8, 16, 8, seed=7))
    with pytest.raises(ValueError, match="CUDA"):
        ssd_kernel.ssd_chunk(*args)


# ---------------------------------------------------------------------------
# chunked SSD: the kernel's wrapper and the plain version
# ---------------------------------------------------------------------------

def test_ssd_chunked_matches_jax_ssd_pallas():
    """L % Q == 0, where the JAX ssd_pallas applies."""
    args = _ssd_inputs(2, 128, 4, 32, 16, seed=15)
    want = jops.ssd_pallas(*_j(*args), chunk=32)
    got = ops.ssd_chunked(*_t(*args), chunk=32)
    assert got.dtype == torch.float32 and got.shape == (2, 128, 4, 32)
    _close(got, want, SSD_TOL)


@pytest.mark.parametrize("impl", ["chunked", "reference"])
@pytest.mark.parametrize("L,chunk", [(1, 8), (5, 8), (37, 8), (77, 256),
                                     (100, 32)])
def test_ssd_ragged_with_state_matches_jax(impl, L, chunk):
    """Any L (padded with dt = 0 to a multiple of Q), an initial state, and
    the final state, against the JAX ssd_reference and ssd_scan."""
    B, H, P, N = 2, 4, 16, 8
    args = _ssd_inputs(B, L, H, P, N, seed=20 + L)
    s0 = 0.5 * _rand((B, H, N, P), seed=40 + L)
    fn = ops.ssd_chunked if impl == "chunked" else ssm.ssd_reference
    y, s = fn(*_t(*args), chunk=chunk, initial_state=torch.from_numpy(s0),
              return_state=True)
    assert y.shape == (B, L, H, P) and s.shape == (B, H, N, P)
    for jfn in (jssm.ssd_reference, jssm.ssd_scan):
        jy, js = jfn(*_j(*args), chunk=chunk, initial_state=jnp.asarray(s0),
                     return_state=True)
        _close(y, jy, SSD_TOL)
        _close(s, js, SSD_TOL)


def test_ssd_chunked_matches_naive_recurrence():
    """The chunked SSD equals the literal sequential recurrence
    S_t = exp(dt_t A) S_{t-1} + dt_t B_t x_t^T, y_t = C_t . S_t (float64),
    independent of chunking."""
    B, L, H, P, N = 1, 24, 2, 8, 4
    x, dt, A, Bm, Cm = _ssd_inputs(B, L, H, P, N, seed=50)
    S = np.zeros((B, H, N, P))
    want = np.zeros((B, L, H, P))
    for t in range(L):
        decay = np.exp(dt[:, t] * A[None])                 # (B,H)
        S = decay[..., None, None] * S + np.einsum(
            "bn,bh,bhp->bhnp", Bm[:, t, 0], dt[:, t], x[:, t])
        want[:, t] = np.einsum("bn,bhnp->bhp", Cm[:, t, 0], S)
    for chunk in (4, 5, 24):
        got = ops.ssd_chunked(*_t(x, dt, A, Bm, Cm), chunk=chunk)
        _close(got, want, SSD_TOL)


@pytest.mark.parametrize("impl", ["chunked", "reference"])
def test_ssd_gradients_stay_finite_where_the_decay_overflows(impl):
    """A chunk whose decay spans more than 88 (dt 2, A -16, Q 64, as
    mamba2-1.3b's random 48 layers reach at full width): exp(cs_i - cs_j)
    overflows above the diagonal.  The port's gradients are finite: those
    of x, B and C equal jax.grad of the reference's ssd_reference and
    ssd_scan, and that of dt the port's own f64 gradient, where the
    reference's is NaN (it takes exp there under a where; a reference
    caveat, ROADMAP §3).  The intra-chunk part's autograd equals
    ssd_chunk_bwd_ref."""
    import jax
    B, L, H, P, N = 1, 64, 2, 4, 3
    x, _, _, Bm, Cm = _ssd_inputs(B, L, H, P, N, seed=70)
    dt = np.full((B, L, H), 2.0, np.float32)
    A = np.array([-16.0, -8.0], np.float32)
    dy = _rand((B, L, H, P), 71)
    fn = ops.ssd_chunked if impl == "chunked" else ssm.ssd_reference

    def grads(dtype):
        leaves = [t.to(dtype).requires_grad_(True)
                  for t in _t(x, dt, Bm, Cm)]
        tx, tdt, tB, tC = leaves
        y = fn(tx, tdt, torch.from_numpy(A).to(dtype), tB, tC, chunk=L)
        return torch.autograd.grad(y, leaves,
                                   torch.from_numpy(dy).to(y.dtype))
    got = grads(torch.float32)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    _close(got[1], grads(torch.float64)[1], SSD_TOL)
    for jfn in (jssm.ssd_reference, jssm.ssd_scan):
        want = jax.grad(lambda a, b, c, d: (jfn(a, b, jnp.asarray(A), c, d,
                                                chunk=L) * dy).sum(),
                        argnums=(0, 1, 2, 3))(*_j(x, dt, Bm, Cm))
        for i in (0, 2, 3):
            _close(got[i], want[i], SSD_TOL)
        assert np.isnan(np.asarray(want[1])).any()
    # the intra-chunk part: autograd of the plain version, the closed form
    xr = torch.from_numpy(x).permute(0, 2, 1, 3)           # (R=1,H,Q,P)
    dtr = torch.from_numpy(dt).permute(0, 2, 1)
    cs = torch.cumsum(dtr * torch.from_numpy(A)[None, :, None], dim=-1)
    Br = torch.from_numpy(Bm).reshape(1, 1, L, N).expand(1, H, L, N)
    Cr = torch.from_numpy(Cm).reshape(1, 1, L, N).expand(1, H, L, N)
    inputs = [t.clone().requires_grad_(True) for t in (xr, dtr, cs, Br, Cr)]
    dys = (torch.from_numpy(_rand((1, H, L, P), 72)),
           torch.from_numpy(_rand((1, H, N, P), 73)))
    got = torch.autograd.grad(ref.ssd_chunk_ref(*inputs), inputs, dys)
    want = ref.ssd_chunk_bwd_ref(*(t.detach() for t in inputs), *dys)
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)


def test_ssd_chunked_takes_one_group_only():
    x, dt, A, Bm, Cm = _t(*_ssd_inputs(1, 8, 4, 8, 4, seed=60))
    with pytest.raises(ValueError, match="G=2"):
        ops.ssd_chunked(x, dt, A, Bm.expand(-1, -1, 2, -1),
                        Cm.expand(-1, -1, 2, -1), chunk=4)


# ---------------------------------------------------------------------------
# decode step and conv
# ---------------------------------------------------------------------------

def test_ssd_decode_step_matches_jax():
    B, H, P, N = 3, 4, 8, 16
    state = _rand((B, H, N, P), 70)
    x, dt = _rand((B, H, P), 71), _softplus(_rand((B, H), 72))
    A = -np.exp(_rand((H,), 73))
    Bm, Cm = _rand((B, 1, N), 74), _rand((B, 1, N), 75)
    y, new = ssm.ssd_decode_step(*_t(state, x, dt, A, Bm, Cm))
    jy, jnew = jssm.ssd_decode_step(*_j(state, x, dt, A, Bm, Cm))
    _close(y, jy, KERNEL_TOL)
    _close(new, jnew, KERNEL_TOL)


@pytest.mark.parametrize("L", [1, 2, 9])
def test_causal_conv_matches_jax(L):
    x, w, b = _rand((2, L, 12), 80), _rand((4, 12), 81), _rand((12,), 82)
    _close(ssm.causal_conv(*_t(x, w, b)), jssm.causal_conv(*_j(x, w, b)),
           KERNEL_TOL)


def test_conv_step_matches_jax():
    st, x = _rand((2, 3, 12), 83), _rand((2, 12), 84)
    w, b = _rand((4, 12), 85), _rand((12,), 86)
    y, new = ssm.conv_step(*_t(st, x, w, b))
    jy, jnew = jssm.conv_step(*_j(st, x, w, b))
    _close(y, jy, KERNEL_TOL)
    _close(new, jnew, KERNEL_TOL)


def test_conv_steps_continue_causal_conv():
    """Stepping the conv token by token from a zero state gives the
    full-sequence conv, which is what prefill hands decode."""
    x, w, b = _t(_rand((2, 7, 12), 87), _rand((4, 12), 88), _rand((12,), 89))
    state = torch.zeros(2, 3, 12)
    steps = []
    for t in range(7):
        y, state = ssm.conv_step(state, x[:, t], w, b)
        steps.append(y)
    _close(torch.stack(steps, 1), ssm.causal_conv(x, w, b), KERNEL_TOL)
