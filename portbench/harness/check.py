"""How ``correct`` is decided: the served tokens against the plain
float32 reference.

Once the window has closed and the program's state is freed, a sample of
the requests the window finished is run through the reference over each
prompt and its served tokens: the longest, and others drawn from the
seed, from slots the sample does not hold yet while there are such. At
each served position the gap is the amount by which the served token's
reference logit lies below the reference's best logit there: greedy
decoding serves the program's best token, so a sound program serves
tokens whose gap is its own rounding, and an altered token, a broken
layer or a lower precision reads wider. Two numbers are read from the
gaps, and a cell's limits file (``cells/<cell>.json``) names those it
compares:

  * ``mean_token_gap``: the mean over every served token of the sample;
  * ``request_mean_gap``: the largest of the sample's per-request means,
    over the requests that served at least ``REQUEST_MIN_TOKENS`` tokens
    (or as many as the longest served), so that wrong tokens confined to
    one request or one slot are not averaged away over the others.

The control reads, at the same positions, the gap of the token that the
reference in float8 puts first.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import model

SAMPLE_TAG = 7
REQUEST_MIN_TOKENS = 128
NUMBERS = ("mean_token_gap", "request_mean_gap")


def sample(reqs, seed: int, n: int):
    """Up to ``n`` finished requests: the longest, and others drawn from
    the seed, each from a slot not yet in the sample while there is
    one."""
    done = sorted((r for r in reqs if r.done is not None),
                  key=lambda r: r.index)
    if not done:
        return []
    longest = max(done, key=lambda r: (len(r.prompt) + r.gen_len, -r.index))
    rest = [r for r in done if r is not longest]
    rng = np.random.default_rng([int(seed) & ((1 << 63) - 1), SAMPLE_TAG])
    fresh, spare, slots = [], [], {longest.slot}
    for i in rng.permutation(len(rest)):
        r = rest[i]
        if r.slot is None or r.slot not in slots:
            fresh.append(r)
            slots.add(r.slot)
        else:
            spare.append(r)
    pick = (fresh + spare)[:max(0, n - 1)]
    return [longest] + sorted(pick, key=lambda r: r.index)


def _sequences(reqs, outputs):
    seqs = [torch.as_tensor(np.concatenate(
                [r.prompt.astype(np.int64),
                 np.asarray(outputs[r.index][:r.gen_len], np.int64)]))
            for r in reqs]
    starts = [len(r.prompt) - 1 for r in reqs]
    return seqs, starts


def _stats(gaps):
    """The numbers of ``NUMBERS`` and, for the record, the widest gap, the
    share above 0 and each request's (tokens, mean gap)."""
    g = torch.cat(gaps)
    per = [(int(x.numel()), float(x.mean())) for x in gaps]
    least = min(REQUEST_MIN_TOKENS, max(n for n, _ in per))
    return {"mean_token_gap": float(g.mean()),
            "request_mean_gap": max(m for n, m in per if n >= least),
            "max": float(g.max()), "share": float((g > 0).float().mean()),
            "requests": per}


def token_gaps(spec, seed, reqs, outputs, device, control: bool = False):
    """``_stats`` of the gaps of the served tokens, the served tokens
    compared, and with ``control`` the same of the float8 control's
    first choices."""
    seqs, starts = _sequences(reqs, outputs)
    ref = model.logits(spec, seed, seqs, starts, device, "fp32")
    ctl = (model.logits(spec, seed, seqs, starts, device, "fp8")
           if control else None)
    served_gaps, ctl_gaps, n = [], [], 0
    for i, (seq, s) in enumerate(zip(seqs, starts)):
        lg = ref[i]
        served = seq[s + 1:].to(lg.device)
        best = lg.max(-1).values
        served_gaps.append(best - lg.gather(1, served[:, None])[:, 0])
        n += served.numel()
        if ctl is not None:
            pick = ctl[i].argmax(-1)
            ctl_gaps.append(best - lg.gather(1, pick[:, None])[:, 0])
    return (_stats(served_gaps), n,
            _stats(ctl_gaps) if control else None)
