"""Whether the timed path served the right tokens.

Once the window has closed and the program's state is freed, a sample of
the requests that finished inside the window is drawn from the seed: the
longest of them (prompt plus output) and then others in the seed's order,
``requests`` in all.  Many requests and few tokens of each: a fault that
touches some rows of the batch (half of it left out, one row's token
altered a step) then shows in the sample whatever rows it hits.  The
reference runs once over each prompt with its served tokens, and each of
the request's last ``tokens_each`` served tokens is judged by its gap: how
far its logit lies below the reference's best at that position (0 where
the served token is the reference's argmax).  The configuration file names
the number compared: the widest gap over the sample or the mean gap.

The control puts the reference computed in float8 in the program's place:
at the same positions it takes the token that the float8 logits put first
and reads that token's gap in the float32 logits.  It runs only in
``calibrate.py``, never in a benchmark run.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from bench import reference
from bench.traffic import STREAM_SAMPLE, rng


def sample(run, seed: int, requests: int) -> List[int]:
    """The rids to compare: the longest finished request, then others in
    the seed's order, ``requests`` in all (every finished one if fewer)."""
    done = run.finished()
    if not len(done):
        return []
    total = run.prompt_lens[done] + run.gens[done]
    longest = int(done[np.argmax(total)])
    rest = [int(r) for r in rng(seed, STREAM_SAMPLE).permutation(done) if r != longest]
    return [longest] + rest[:requests - 1]


def gaps(params, model: dict, prompt: np.ndarray, served: List[int], tokens_each: int,
         device, *, control: bool = False) -> Dict[str, np.ndarray]:
    """Per judged token (the last ``tokens_each`` served): the program's
    gap, and with ``control`` the float8 reference's gap at the same
    positions."""
    seq = np.concatenate([np.asarray(prompt, np.int64), np.asarray(served[:-1], np.int64)])
    toks = torch.from_numpy(seq).to(device)
    judged = served[-tokens_each:]
    ref = reference.logits(params, model, toks, len(judged))
    best = ref.max(dim=-1).values
    served_t = torch.as_tensor(judged, device=device).long()
    out = {"program": (best - ref.gather(1, served_t[:, None])[:, 0]).cpu().numpy()}
    if control:
        low = reference.logits(params, model, toks, len(judged), fp8=True)
        pick = low.argmax(dim=-1)
        out["control"] = (best - ref.gather(1, pick[:, None])[:, 0]).cpu().numpy()
    return out


def compare(run, params, model: dict, prompts, seed: int, plan: dict, device, *,
            control: bool = False) -> Dict[str, np.ndarray]:
    """Gaps of every judged token of the sample, concatenated; ``plan`` is
    the mix's ``check`` (``requests``, ``tokens_each``).  Token ids outside
    the vocabulary are reported apart (they have no gap)."""
    out = {"program": [], "control": [], "rids": sample(run, seed, plan["requests"]),
           "bad_ids": 0}
    for r in out["rids"]:
        served = run.tokens[r]
        bad = sum(1 for x in served if not 0 <= x < model["vocab"])
        if bad:
            out["bad_ids"] += bad
            continue
        g = gaps(params, model, prompts[r], served, plan["tokens_each"], device,
                 control=control)
        for k, v in g.items():
            out[k].append(v)
    for k in ("program", "control"):
        out[k] = np.concatenate(out[k]) if out[k] else np.zeros(0)
    return out


STATS = {
    "max_logit_gap": lambda g: float(g.max()),
    "mean_logit_gap": lambda g: float(g.mean()),
}


def numbers(cmp: dict, limits: dict) -> Dict[str, dict]:
    """The numbers compared, each beside its limit, and whether it holds:
    the gap statistics that the configuration file's ``check`` names
    (``STATS``), that every sampled token was compared, and that none lies
    outside the vocabulary."""
    prog = cmp["program"]
    rows = {name: {"value": STATS[name](prog) if prog.size else None, "limit": lim,
                   "rule": "<="} for name, lim in limits.items()}
    rows["tokens_compared"] = {"value": int(prog.size), "limit": 1, "rule": ">="}
    rows["requests_compared"] = {"value": len(cmp["rids"]), "limit": 1, "rule": ">="}
    rows["token_ids_outside_vocab"] = {"value": int(cmp["bad_ids"]), "limit": 0, "rule": "<="}
    for row in rows.values():
        v, lim = row["value"], row["limit"]
        row["ok"] = v is not None and lim is not None and (
            v <= lim if row["rule"] == "<=" else v >= lim)
    return rows
