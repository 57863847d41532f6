"""The port imports no JAX and nothing of the JAX package, and its entry
points refuse to run on the CPU unless the caller asks for it."""

import pathlib
import runpy
import subprocess
import sys

import pytest
import torch

pytestmark = pytest.mark.port

ROOT = pathlib.Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, pkgutil, runpy, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
runpy.run_path(sys.argv[1], run_name="chip_smoke_import_probe")
for path in sys.argv[2:]:
    runpy.run_path(path, run_name="example_import_probe")
leaked = sorted(m for m in sys.modules
                if m == "jax" or m.startswith("jax.") or m == "repro"
                or m.startswith("repro."))
print(len(names), leaked, " ".join(names))
assert not leaked, leaked
"""

#: modules of the per-layer kernel-mode and DB-PIM pipeline slice, the
#: row-stable kernels, the compiled steps, the SSM and the MoE families,
#: fault injection and tracing, durability and paging, the training path,
#: the paper side; the probe imports every module of the package, these
#: among them
SLICE_MODULES = {
    "repro_torch.core.dyadic", "repro_torch.core.pim_model",
    "repro_torch.core.pruning", "repro_torch.core.qat",
    "repro_torch.kernels.block_sparse_matmul",
    "repro_torch.kernels.dbmu_sim", "repro_torch.kernels.fta_int8_matmul",
    "repro_torch.kernels.row_attention", "repro_torch.kernels.row_norm",
    "repro_torch.quickstart", "repro_torch.obs.sentinel",
    "repro_torch.obs.launches", "repro_torch.launch.steps",
    "repro_torch.models.ssm", "repro_torch.models.moe",
    "repro_torch.serving.faults", "repro_torch.obs.trace",
    "repro_torch.obs.chrome", "repro_torch.launch.report",
    "repro_torch.runtime.fault", "repro_torch.checkpoint.checkpoint",
    "repro_torch.serving.journal", "repro_torch.serving.snapshot",
    "repro_torch.serving.paging", "repro_torch.runtime.op_cost",
    "repro_torch.obs.waterfall", "repro_torch.optim.adamw",
    "repro_torch.optim.schedule", "repro_torch.data.pipeline",
    "repro_torch.runtime.compression", "repro_torch.launch.train",
    "repro_torch.core.hybrid", "repro_torch.configs.paper_cnns",
    "repro_torch.core.workload_gen", "repro_torch.launch.mesh",
    "repro_torch.runtime.sharding", "repro_torch.runtime.act_sharding",
    "repro_torch.launch.dryrun", "repro_torch.launch.roofline"}

#: the port's example scripts (examples/<name>.py), imported by the probe
EXAMPLES = ("torch_serve_lm", "torch_train_lm", "torch_dbpim_compress_lm")


def test_port_and_chip_smoke_import_no_jax():
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    res = subprocess.run([sys.executable, "-c", _PROBE,
                          str(ROOT / "chip_smoke.py"),
                          *(str(ROOT / "examples" / f"{name}.py")
                            for name in EXAMPLES)],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    n_modules = int(res.stdout.split()[0])
    assert n_modules >= 28
    assert SLICE_MODULES <= set(res.stdout.split()[2:])


def test_entry_points_raise_without_a_card():
    """Default device is CUDA: with no card they raise, never run on the
    CPU silently; device="cpu" is the explicit opt-in."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    from repro_torch.configs import get_config
    from repro_torch.launch import serve, train
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch import quickstart
    from repro_torch.models import init_cache, init_params
    from repro_torch.serving import ServeEngine
    from repro_torch.weights import params_from_numpy
    from repro_torch.sparsity.sparse_linear import init_stacked_serving
    cfg = get_config("tinyllama-1.1b", reduced=True)
    moe_cfg = get_config("mixtral-8x7b", reduced=True, dbpim_mode="joint")
    for call in (lambda: init_params(cfg),
                 lambda: init_params(moe_cfg),
                 lambda: init_stacked_serving(moe_cfg),
                 lambda: serve.main(["--arch", "mixtral-8x7b", "--reduced",
                                     "--dbpim-mode", "joint"]),
                 lambda: serve.main(["--arch", "arctic-480b", "--reduced",
                                     "--dbpim-mode", "joint"]),
                 lambda: init_cache(cfg, 2, 8),
                 lambda: ServeEngine(cfg, {}),
                 lambda: params_from_numpy({"w": torch.zeros(2).numpy()}),
                 lambda: serve.main(["--arch", "tinyllama-1.1b",
                                     "--reduced"]),
                 lambda: train.main(["--arch", "tinyllama-1.1b",
                                     "--reduced", "--steps", "1"]),
                 lambda: quickstart.main([]),
                 lambda: make_test_mesh(),
                 *(lambda name=name: runpy.run_path(
                     str(ROOT / "examples" / f"{name}.py"),
                     run_name="example_probe")["main"]([])
                   for name in EXAMPLES)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    params = init_params(cfg, device="cpu")
    assert params["blocks"]["attn"]["wq"].device.type == "cpu"
    params, tables = init_stacked_serving(moe_cfg, device="cpu")
    assert params["blocks"]["moe"]["router"].device.type == "cpu"
    assert tables.arrays["moe/w_gate"]["w_blocks"].device.type == "cpu"


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """chip_smoke.py exits non-zero, printing no result, without a card
    and in a directory that holds it alone."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"), (tmp_path, lone)):
        res = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             capture_output=True, text=True, timeout=120,
                             env={"PATH": "/usr/bin:/bin"})
        assert res.returncode != 0
        assert '"ok": true' not in res.stdout
