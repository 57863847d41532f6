"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level names (the port's ``repro_torch`` begins with ``repro``),
and the reference loads nothing of the port."""

import subprocess
import sys

from conftest import ROOT

PROBE_RUN = r"""
import sys, importlib.util
sys.path[:0] = ["src", ".", "portbench/tests"]
spec = importlib.util.spec_from_file_location("r", "portbench/run.py")
run = importlib.util.module_from_spec(spec); spec.loader.exec_module(run)
import torch
from conftest import small_cell
for cfg in ("stablelm-1.6b", "mixtral-8x7b"):
    run.execute(small_cell(cfg), 3, 0.5, True, torch.device("cpu"))
top = {m.split(".")[0] for m in sys.modules}
print(sorted(top & {"jax", "jaxlib", "flax", "repro"}))
print("repro_torch" in top, run.forbidden_modules())
"""

PROBE_REF = r"""
import sys
sys.path[:0] = ["src", ".", "portbench/tests"]
import torch
from portbench.reference import compress, model, slices
from conftest import reduced
spec = reduced("mixtral-8x7b")
model.logits(spec, 1, [torch.arange(1, 9)], [3], torch.device("cpu"),
             "fp8")
top = {m.split(".")[0] for m in sys.modules}
print(sorted(top & {"jax", "jaxlib", "flax", "repro", "repro_torch"}))
"""


def _probe(code):
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    return p.stdout.strip().splitlines()


def test_harness_loads_no_jax():
    lines = _probe(PROBE_RUN)
    assert lines[-2] == "[]"
    assert lines[-1] == "True []"


def test_reference_loads_nothing_of_either_package():
    assert _probe(PROBE_REF)[-1] == "[]"


def test_sources_name_no_jax():
    """No file of the benchmark imports jax, jaxlib, flax or repro."""
    import re
    bad = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|flax|repro)(\s|\.|$)",
                     re.M)
    for path in (ROOT / "portbench").rglob("*.py"):
        assert not bad.search(path.read_text()), path
    ref = re.compile(r"^\s*(from|import)\s+repro_torch", re.M)
    for path in (ROOT / "portbench" / "reference").rglob("*.py"):
        assert not ref.search(path.read_text()), path
