"""The port's recompile sentinel against the JAX package's: over the same
sequence of input signatures, the reference's sentinel over a ``jax.jit``
step and the port's over ``launch.steps.compile_step`` give the same
counts, raise ``RecompileError`` at the same call and say the same thing;
and the port's sentinel guards the engine's real steps.

    PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q -m port \
        tests/test_torch_sentinel.py
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.obs.sentinel import RecompileError as JaxRecompileError
from repro.obs.sentinel import RecompileSentinel as JaxSentinel
from repro_torch.configs import get_config
from repro_torch.launch.steps import build_step, compile_step
from repro_torch.models import init_cache, init_params
from repro_torch.obs import RecompileError, RecompileSentinel

pytestmark = pytest.mark.port

#: the per-call input of each call: (shape, dtype); the params and the
#: cache stay the same buffers throughout
SIGNATURES = [((4,), "float32"), ((4,), "float32"), ((5,), "float32"),
              ((4,), "float32"), ((4,), "int32"), ((5,), "float32"),
              ((2, 2), "float32")]


def _toy_step(params, cache, x):
    return x * 2 + params["w"].sum().to(x.dtype), cache


def _toy_steps():
    _toy_step.call_kind, _toy_step.arch = "decode", "toy"
    port = compile_step(_toy_step, buffer_argnums=(0, 1))
    ref = jax.jit(lambda params, cache, x: (
        x * 2 + params["w"].sum().astype(x.dtype), cache))
    return port, ref


def _raised(sentinel, error):
    try:
        sentinel.check()
    except error as exc:
        return str(exc)
    return None


@pytest.mark.parametrize("budget", [1, 2])
def test_counts_and_raises_match_the_reference(budget):
    """Call by call: the same compile counts, the same call raising, the
    same message (the same keys)."""
    port, ref = _toy_steps()
    mine, theirs = RecompileSentinel(budget), JaxSentinel(budget)
    key = RecompileSentinel.key("decode", "toy")
    assert key == JaxSentinel.key("decode", "toy") == "decode@toy"
    mine.register(key, port)
    theirs.register(key, ref)
    params = {"w": torch.ones((3,))}
    cache = {"k": torch.zeros((2, 3))}
    jparams = {"w": jnp.ones((3,))}
    jcache = {"k": jnp.zeros((2, 3))}
    assert mine.available and theirs.available
    first_raise = None
    for i, (shape, dtype) in enumerate(SIGNATURES):
        x = np.arange(np.prod(shape)).reshape(shape).astype(dtype)
        got, _ = port(params, cache, torch.from_numpy(x))
        want, _ = ref(jparams, jcache, jnp.asarray(x))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert mine.counts() == theirs.counts(), i
        msg, jmsg = _raised(mine, RecompileError), _raised(theirs,
                                                          JaxRecompileError)
        assert msg == jmsg, i
        if msg is not None and first_raise is None:
            first_raise = i
    assert mine.counts() == {key: 4}
    assert first_raise == (2 if budget == 1 else 4)


def test_new_buffer_is_a_new_signature():
    """The compiled step holds its buffer arguments where they lie: a
    cache replaced by another (equal values, another address) is another
    signature, as a graph captured on the old one could not serve it."""
    port, _ = _toy_steps()
    sentinel = RecompileSentinel()
    sentinel.register("decode@toy", port)
    params = {"w": torch.ones((3,))}
    x = torch.zeros((4,))
    cache = {"k": torch.zeros((2, 3))}
    port(params, cache, x)
    port(params, cache, x.clone())          # per-call inputs: by value
    sentinel.check()
    port(params, {"k": cache["k"].clone()}, x)
    assert sentinel.counts() == {"decode@toy": 2}
    with pytest.raises(RecompileError, match=r"decode@toy compiled 2x"):
        sentinel.check()


def test_inert_without_the_hook():
    """A step without ``_cache_size`` leaves the sentinel inert, as the
    reference's does on a jax build without the hook."""
    sentinel = RecompileSentinel()
    sentinel.register("decode@toy", _toy_step)
    assert not sentinel.available
    assert sentinel.counts() == {"decode@toy": -1}
    sentinel.check()


@pytest.fixture(scope="module")
def reduced():
    cfg = get_config("tinyllama-1.1b", reduced=True).scaled(dtype="float32")
    return cfg, init_params(cfg, seed=0, device="cpu")


def _slot_cache(cfg, B, max_len):
    cache = init_cache(cfg, B, max_len, device="cpu")
    cache["pos"] = torch.zeros((B,), dtype=torch.int32)
    cache["attn"]["pos"] = torch.zeros((B,), dtype=torch.int32)
    return cache


def test_decode_step_whose_shape_changes_raises(reduced):
    """The engine's in-place decode step, compiled: a token batch of
    another dtype after warm-up is a second compile, and the next check()
    raises naming the step."""
    cfg, params = reduced
    step = compile_step(build_step(cfg, "decode"),
                        buffer_argnums=(0, 1))
    sentinel = RecompileSentinel()
    key = RecompileSentinel.key("decode", cfg.name)
    sentinel.register(key, step)
    cache = _slot_cache(cfg, 2, 8)
    active = torch.tensor([True, False])
    for _ in range(3):
        step(params, cache, torch.ones((2, 1), dtype=torch.int32), active)
        sentinel.check()
    assert sentinel.counts() == {key: 1}
    step(params, cache, torch.ones((2, 1), dtype=torch.int64), active)
    with pytest.raises(RecompileError, match=f"{key} compiled 2x"):
        sentinel.check()
