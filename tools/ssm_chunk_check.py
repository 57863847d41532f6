"""How far mamba2-1.3b's prefill chunks land from stepwise decode at full
width, and what a planted fault reads against the same measures.

    python3 tools/ssm_chunk_check.py --impl port            # needs a card
    JAX_PLATFORMS=cpu python3 tools/ssm_chunk_check.py --impl jax

One random 40-token prompt (seed 9) goes through stepwise decode at batch
1 and through chunks of 16 (the last one ragged), and the first-token
logits are compared: max |d|, the logits' peak and whether the
reference's absolute ``PARALLEL_PREFILL_ATOL`` holds.

``--impl jax`` runs the reference's dense params (its own random init) at
full depth on the CPU, in the parallel and the exact chunk form; it needs
~20 GB of host memory.

``--impl port`` runs joint mode (vs = 0.6, the serve CLI's packs and
params from seed 0) on the card, in bf16 and in a float32 copy, the
parallel chunk against stepwise decode at depths 1, 4, 12 and 48 and
every row below at full depth (48), through ``chip_smoke``'s own runs
and measures (``_stepwise_run``, ``_chunked_run``, ``_ssm_gaps``), so
each row reads what ``chip_smoke``'s bounds read. Rows: the exact chunk
and the parallel chunk against stepwise decode, and the parallel chunk
against the same chunk through the plain versions (the serve phase's
comparison); each parallel comparison also with a fault planted in the
chunk side, in memory only: ``carry`` drops the carried state
(``_ssd_chunk`` seeded with zeros), ``conv`` gathers the new conv window
one row early, ``dt`` zeroes the in-projection's dt columns (the joint
kernel's partial last N tile). One JSON object per line.
"""

from __future__ import annotations

import argparse
import contextlib
import inspect
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
PROMPT, CHUNK = 40, 16
#: the port's depths: the clean parallel chunk at each, every row at 48
LAYERS = (1, 4, 12, 48)


def _prompt(vocab):
    return np.random.default_rng(9).integers(1, vocab, (1, PROMPT)).astype(
        np.int32)


def _row(impl, dtype, layers, mode, lc, ls, atol):
    d = float(np.abs(lc - ls).max())
    return {"impl": impl, "dtype": dtype, "layers": layers, "mode": mode,
            "max_abs_d": d, "peak": float(np.abs(ls).max()),
            "atol": atol, "atol_holds": d <= atol,
            "bitwise": bool(np.array_equal(lc, ls))}


@contextlib.contextmanager
def _planted(fault):
    """One fault in the port's SSM chunk, in memory, for the duration."""
    import torch

    from repro_torch.models import ssm
    saved = {name: getattr(ssm, name) for name in
             ("_ssd_chunk", "_split_proj", "prefill_ssm_parallel")}
    if fault == "carry":
        ssd = saved["_ssd_chunk"]
        ssm._ssd_chunk = lambda state, *a: ssd(torch.zeros_like(state), *a)
    elif fault == "dt":
        split = saved["_split_proj"]

        def zero_dt(proj, cfg):
            z, xbc, dt = split(proj, cfg)
            return z, xbc, torch.zeros_like(dt)
        ssm._split_proj = zero_dt
    elif fault == "conv":
        src = inspect.getsource(saved["prefill_ssm_parallel"])
        early = src.replace("gather = (n_valid[:, None]",
                            "gather = (n_valid[:, None] - 1")
        assert early != src
        space = dict(vars(ssm))
        exec(compile(early, ssm.__file__, "exec"), space)
        ssm.prefill_ssm_parallel = space["prefill_ssm_parallel"]
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(ssm, name, fn)


def run_port():
    import torch
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    args = serve.build_parser().parse_args(cs.SSM_SERVE_ARGS)
    for dtype in ("bfloat16", "float32"):
        for n in LAYERS:
            cfg = get_config("mamba2-1.3b", dbpim_mode="joint").scaled(
                dtype=dtype, n_layers=n)
            engine, _, tables = serve.build_engine_and_trace(args, cfg)
            prompt = _prompt(cfg.vocab_size)[0].tolist()
            step = cs._stepwise_run(engine, tables, prompt)
            rows = []
            if n == LAYERS[-1]:
                exact = cs._chunked_run(engine, tables, prompt, CHUNK,
                                        cfg.scaled(prefill_exact=True))
                with cs.plain_versions():
                    plain = cs._chunked_run(engine, tables, prompt, CHUNK)
                rows.append(("exact vs stepwise", "none", exact, step))
            for fault in ("none", "carry", "conv", "dt")[
                    :4 if n == LAYERS[-1] else 1]:
                with _planted(fault):
                    par = cs._chunked_run(engine, tables, prompt, CHUNK)
                if fault != "dt":
                    rows.append(("parallel vs stepwise", fault, par, step))
                if fault != "conv" and n == LAYERS[-1]:
                    rows.append(("parallel vs plain", fault, par, plain))
            for what, fault, got, ref in rows:
                print(json.dumps({"impl": "port", "dtype": dtype,
                                  "layers": n, "compare": what,
                                  "fault": fault,
                                  **cs._ssm_gaps(got, ref, prompt[-1])}),
                      flush=True)
            del engine, tables, step, rows
            torch.cuda.empty_cache()


def run_jax():
    sys.path.insert(0, str(ROOT / "src"))
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.models import decode_chunk, decode_step, init_cache
    from repro.models import init_params
    from repro.models.ssm import PARALLEL_PREFILL_ATOL
    for dtype in ("bfloat16", "float32"):
        cfg = get_config("mamba2-1.3b").scaled(dtype=dtype)
        params = init_params(cfg, jax.random.PRNGKey(0))
        prompt = _prompt(cfg.vocab_size)

        def fresh(c):
            cache = init_cache(c, 1, 64)
            cache["pos"] = jnp.zeros((1,), jnp.int32)
            return cache

        step = jax.jit(lambda p, c, t: decode_step(p, c, t, cfg))
        cache = fresh(cfg)
        for t in range(PROMPT):
            lg, cache = step(params, cache, jnp.asarray(prompt[:, t:t + 1]))
        ls = np.asarray(lg[0, 0], np.float32)
        for mode in ("parallel", "exact"):
            c = cfg.scaled(prefill_exact=mode == "exact")
            chunk = jax.jit(lambda p, cc, t, n, c=c: decode_chunk(p, cc, t,
                                                                  n, c))
            cache = fresh(c)
            for s in range(0, PROMPT, CHUNK):
                k = min(CHUNK, PROMPT - s)
                toks = np.zeros((1, CHUNK), np.int32)
                toks[:, :k] = prompt[:, s:s + k]
                lg, cache = chunk(params, cache, jnp.asarray(toks),
                                  jnp.full((1,), k, jnp.int32))
            print(json.dumps(_row("jax", dtype, cfg.n_layers, mode,
                                  np.asarray(lg[0, 0], np.float32), ls,
                                  PARALLEL_PREFILL_ATOL[dtype])), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--impl", choices=("port", "jax"), required=True)
    args = ap.parse_args(argv)
    if args.impl == "port":
        run_port()
    else:
        run_jax()
    return 0


if __name__ == "__main__":
    sys.exit(main())
