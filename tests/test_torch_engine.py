"""repro_torch serving engine vs the JAX Engine on qwen2-1.5b-smoke (CPU):
the same greedy tokens, token for token, and the same lifecycle rules."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_mkl import init_vml  # noqa: E402

init_vml()      # before any test: tests/_torch_mkl.py says why

import jax.numpy as jnp  # noqa: E402

from repro.models import api as japi  # noqa: E402
from repro.models import get_config as jget_config  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import get_config  # noqa: E402
from repro_torch.serve import Engine, Request  # noqa: E402

from _torch_parity import shared_params  # noqa: E402

ARCH = "qwen2-1.5b-smoke"


@pytest.fixture(scope="module")
def params():
    return shared_params(ARCH)


def _engines(params, **kw):
    jp, tp = params
    return (JEngine(jget_config(ARCH), jp, **kw),
            Engine(get_config(ARCH), tp, device="cpu", **kw))


def _serve(engines, requests):
    """Submit the same requests to both engines, drain both, return the
    outputs of each by uid."""
    outs = []
    for eng, cls in zip(engines, (JRequest, Request)):
        for uid, prompt, n in requests:
            eng.submit(cls(uid=uid, prompt=np.asarray(prompt, np.int32),
                           max_new_tokens=n))
        done = eng.run_until_drained()
        outs.append({r.uid: r.output for r in done})
    return outs


def _greedy_reference(params, prompt, n_new, max_seq=48):
    """tests/test_serve.py's single-request greedy decode, on the JAX side."""
    jp, _ = params
    cfg = jget_config(ARCH)
    cache = japi.init_cache(cfg, 1, max_seq)
    lg, cache = japi.prefill(jp, cfg, cache,
                             {"tokens": jnp.asarray(prompt)[None]})
    out = [int(jnp.argmax(lg[0]))]
    for _ in range(n_new - 1):
        lg, cache = japi.decode_step(jp, cfg, cache,
                                     jnp.asarray([out[-1]], jnp.int32))
        out.append(int(jnp.argmax(lg[0])))
    return out


def test_continuous_batching_matches_jax(params):
    """tests/test_serve.py::test_continuous_batching_exact's requests."""
    requests = [(0, [5, 6, 7, 8], 6), (1, [1, 2], 3), (2, [9, 9, 9], 8)]
    jout, tout = _serve(_engines(params, slots=3, max_seq=48), requests)
    assert tout == jout
    assert tout[0] == _greedy_reference(params, [5, 6, 7, 8], 6)


def test_slot_reuse_matches_jax(params):
    """7 requests on 2 slots: admission order, splice and retirement."""
    rng = np.random.default_rng(0)
    cfg = get_config(ARCH)
    requests = [(i, rng.integers(0, cfg.vocab_size, int(rng.integers(2, 9))),
                 int(rng.integers(1, 7))) for i in range(7)]
    engines = _engines(params, slots=2, max_seq=48)
    jout, tout = _serve(engines, requests)
    assert tout == jout and len(tout) == 7
    assert engines[1].stats() == engines[0].stats()


def test_idle_slot_runs_past_max_seq(params):
    """Requests served one at a time take slot 0; slot 1 idles, and its
    position keeps growing past max_seq.  Its cache write clamps as the
    reference's does, with no error, and the tokens stay the same."""
    max_seq = 12
    engines = _engines(params, slots=2, max_seq=max_seq)
    rng = np.random.default_rng(1)
    for uid in range(5):
        prompt = rng.integers(0, 256, 3)
        jout, tout = _serve(engines, [(uid, prompt, 6)])
        assert tout == jout
    assert engines[1]._pos[1] == int(engines[0].cache["pos"][1]) > max_seq


def test_edge_rules_match_jax(params):
    """Oversize prompts are rejected at submit, zero-token requests finish
    without a slot, single-token requests stop at the prefill, and the
    max_seq cap ends a long request."""
    engines = _engines(params, slots=1, max_seq=12)
    for eng, cls in zip(engines, (JRequest, Request)):
        too_long = cls(uid=9, prompt=np.arange(12, dtype=np.int32))
        assert eng.submit(too_long) is False and too_long.rejected
    requests = [(0, [1, 2], 0), (1, [5, 6, 7], 1),
                (2, np.arange(8), 100)]
    jout, tout = _serve(engines, requests)
    assert tout == jout
    assert tout[0] == [] and len(tout[1]) == 1
    assert len(tout[2]) == 12 - 8 + 1 - 1
    assert engines[1].stats() == engines[0].stats()


def test_engine_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device='cuda' is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(get_config(ARCH), {}, slots=1, max_seq=8)


def test_launcher_serves_on_cpu(capsys):
    assert launch_serve.main(["--device", "cpu", "--requests", "3",
                              "--max-new", "4"]) == 0
    assert "served 3 requests, 12 tokens" in capsys.readouterr().out
