"""The port's example scripts on the CPU: ``examples/torch_dbpim_compress_lm.py``
fed the JAX example's params and batch against the JAX package's own
pipeline, ``examples/torch_serve_lm.py`` serving its trace, and
``examples/torch_train_lm.py`` training the smoke config and, with
``--full``, swapping the registry's reduced config and putting it back.

    PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q -m port \
        tests/test_torch_examples.py
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.data import SyntheticLMDataset as JaxDataset
from repro.models import init_params as jax_init_params
from repro.models import loss_fn as jax_loss_fn
from repro.sparsity import dequant_tree as jax_dequant_tree
from repro.sparsity import pim_speedup_estimate as jax_pim_speedup_estimate
from repro.sparsity import sparsify_params as jax_sparsify_params
from repro_torch.configs import get_config
from repro_torch.weights import params_from_numpy

pytestmark = pytest.mark.port

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"

#: loss of the compressed model, relative: in float32 the two packages'
#: CPU matmuls differ in their last bits only; in the example's own
#: bfloat16 each package rounds its bf16 products at its own places
#: (5e-5 seen), so the bf16 case is held to 1e-3, under a bf16 ulp
LOSS_RTOL = {"float32": 1e-5, "bfloat16": 1e-3}


def _example(name):
    spec = importlib.util.spec_from_file_location(
        f"torch_example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_example_rows(jcfg, params, batch):
    """The figures examples/dbpim_compress_lm.py prints, per value
    sparsity, from the JAX package's pipeline."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    base = float(jax_loss_fn(params, jb, jcfg))
    rows = []
    for vs in (0.0, 0.4, 0.6):
        comp = jax_sparsify_params(params, jcfg, value_sparsity=vs)
        est = jax_pim_speedup_estimate(comp, jcfg)
        rows.append(dict(
            value_sparsity=vs, base_loss=base,
            loss=float(jax_loss_fn(jax_dequant_tree(params, comp), jb, jcfg)),
            bit_sparsity=float(np.mean([r["bit_sparsity"]
                                        for r in comp.report.values()])),
            orig_bytes=sum(r["orig_bytes"] for r in comp.report.values()),
            int8_bytes=sum(r["int8_bytes"] for r in comp.report.values()),
            speedup=est["speedup"], energy_savings=est["energy_savings"],
            u_act=est["u_act"], n_projections=est["n_projections"]))
    return rows


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_dbpim_compress_example_matches_the_references(dtype):
    """The example's tinyllama smoke config (bf16, and a float32 copy),
    JAX params from PRNGKey(0) and the synthetic batch at step 0: bytes,
    projection count and bit sparsity exactly, the cost model's speedup,
    energy savings and U_act within 1e-5 relative, the losses within
    LOSS_RTOL."""
    jcfg = jax_get_config("tinyllama-1.1b", reduced=True).scaled(dtype=dtype)
    cfg = get_config("tinyllama-1.1b", reduced=True).scaled(dtype=dtype)
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    batch = JaxDataset(jcfg, 8, 128, seed=0).batch_at(0)
    want = _jax_example_rows(jcfg, jp, batch)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    got = _example("torch_dbpim_compress_lm").run(cfg, params, batch, "cpu")
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for key in ("value_sparsity", "orig_bytes", "int8_bytes",
                    "n_projections", "bit_sparsity"):
            assert g[key] == w[key], (key, g[key], w[key])
        for key in ("speedup", "energy_savings", "u_act"):
            np.testing.assert_allclose(g[key], w[key], rtol=1e-5,
                                       err_msg=key)
        for key in ("base_loss", "loss"):
            np.testing.assert_allclose(g[key], w[key], rtol=LOSS_RTOL[dtype],
                                       err_msg=key)


def test_dbpim_compress_example_runs_its_own_init():
    rows = _example("torch_dbpim_compress_lm").main(["--device", "cpu"])
    assert [r["value_sparsity"] for r in rows] == [0.0, 0.4, 0.6]
    assert all(np.isfinite(r["loss"]) and r["speedup"] > 1 for r in rows)


def test_serve_example_serves_its_trace():
    """Reduced mixtral (MoE, a window of 32 past max-len 64: stepwise
    prefill), 8 requests of 12 tokens through 4 slots."""
    outputs = _example("torch_serve_lm").main(["--device", "cpu"])
    assert sorted(outputs) == list(range(8))
    vocab = get_config("mixtral-8x7b", reduced=True).vocab_size
    for toks in outputs.values():
        assert len(toks) == 12 and all(0 <= t < vocab for t in toks)


def test_train_example_trains_and_resumes(tmp_path, monkeypatch):
    """The smoke config's settings (batch 16 x seq 128) for 50 steps, the
    checkpoint cadence; its checkpoint directory lies under the temporary
    directory, so a second run of 50 steps resumes at step 50 and has
    nothing left to train."""
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    ex = _example("torch_train_lm")
    argv = ["--steps", "50", "--device", "cpu"]
    losses = ex.main(argv)
    assert len(losses) == 50 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    assert (tmp_path / "repro_torch_ckpt_smoke").is_dir()
    assert ex.main(argv) == []


def test_train_example_full_swaps_the_reduced_config_back():
    """--full trains the 12 x 768 variant through --reduced and leaves the
    registry as it found it, also when training raises."""
    import repro_torch.configs.tinyllama_1_1b as t
    ex = _example("torch_train_lm")
    before = t.reduced_config
    seen = {}

    def fake_train(argv):
        seen["argv"] = argv
        seen["cfg"] = get_config("tinyllama-1.1b", reduced=True)
        raise RuntimeError("stop")

    ex.train_main = fake_train
    with pytest.raises(RuntimeError, match="stop"):
        ex.main(["--full", "--steps", "2", "--device", "cpu"])
    cfg = seen["cfg"]
    assert (cfg.name, cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.d_ff, cfg.vocab_size) == ("tinyllama-100m", 12, 768, 12, 4,
                                          2048, 32000)
    assert seen["argv"][:7] == ["--arch", "tinyllama-1.1b", "--reduced",
                                "--steps", "2", "--batch", "8"]
    assert t.reduced_config is before
    assert get_config("tinyllama-1.1b", reduced=True).name == "tinyllama-smoke"
