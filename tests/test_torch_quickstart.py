"""The port's quickstart on the CPU prints the result lines of
examples/quickstart.py: the same value sparsity, phi histogram, bit
sparsity, pack/unpack and bit-true DBMU results, cost-model speedup,
energy and utilization, and joint weight bytes; its joint kernel error
stays at fp32 rounding."""

import contextlib
import importlib.util
import io
import pathlib

import pytest

from repro_torch import quickstart

pytestmark = pytest.mark.port

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _result_lines(text: str):
    """The indented result lines (the step headers name each package's own
    kernels and differ)."""
    return [ln.strip() for ln in text.splitlines() if ln.startswith("   ")]


def test_quickstart_prints_the_reference_results():
    spec = importlib.util.spec_from_file_location(
        "jax_quickstart", ROOT / "examples" / "quickstart.py")
    jax_quickstart = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_quickstart)
    ref_out, out = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(ref_out):
        jax_quickstart.main()
    with contextlib.redirect_stdout(out):
        res = quickstart.main(["--device", "cpu"])
    ref, got = _result_lines(ref_out.getvalue()), _result_lines(
        out.getvalue())
    assert len(got) == len(ref) == 7
    # every line but the joint kernel's error, which is each package's own
    # fp32 sum order
    assert got[:-1] == ref[:-1]
    cut = ref[-1].index("max |kernel")
    assert got[-1][:cut] == ref[-1][:cut]
    assert res["pack_exact"] and res["dbmu_exact"]
    assert res["joint_err"] < 1e-5
    assert [ln for ln in out.getvalue().splitlines()
            if ln.startswith("==")][3].endswith("(dbmu_matmul on cpu)")
