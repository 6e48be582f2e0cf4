"""Whether the timed path served the right tokens.

Once the window has closed and the program's state is freed, a sample of
the requests that finished inside the window is drawn from the seed: the
longest of them (prompt plus output) and then the others in the order of
the seed's ranks, ``requests`` in all.  Many requests and few tokens of
each: a fault that touches some rows of the batch (half of it left out,
one row's token altered a step) then shows in the sample whatever rows it
hits.  The configuration's model module (``spec.model_module``: the file
its ``reference`` names, or ``bench/reference.py``) runs once over each
prompt with its served tokens, and each of the request's last
``tokens_each`` served tokens is judged:

  * its gap: how far its logit lies below the reference's best at that
    position (0 where the served token is the reference's argmax);
  * with the logits tap (``bench/tap.py``): whether it is the argmax of
    the program's own logits at its step, and how far those logits lie
    from the reference's (``_err``).

The statistics are files, ``bench/checks/<stat>.py``, each a ``read`` of
one side's arrays (``gaps``, ``err``, ``not_argmax``); the configuration
file's ``check`` names those it compares and their limits.

The control puts the model module computed in float8 in the program's
place: at the same positions it takes the token that the float8 logits put
first, reads that token's gap in the float32 logits and the float8 logits'
distance from them; its tokens are its own argmax.  It runs only in
``calibrate.py``, never in a benchmark run.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from bench import reference, spec
from bench.traffic import STREAM_SAMPLE, rng


def ranks(seed: int, n: int) -> np.ndarray:
    """The seed's order of ``n`` requests: the rank of each rid."""
    return rng(seed, STREAM_SAMPLE).permutation(n)


def sample(run, seed: int, requests: int, eligible: Optional[np.ndarray] = None) -> List[int]:
    """The rids to compare: the longest finished request, then the others
    by their rank in the seed's order, ``requests`` in all (every finished
    one if fewer).  ``eligible``: the rids that may be drawn (all)."""
    done = run.finished()
    if eligible is not None:
        done = done[eligible[done]]
    if not len(done):
        return []
    total = run.prompt_lens[done] + run.gens[done]
    longest = int(done[np.argmax(total)])
    order = ranks(seed, len(run.gens))
    rest = sorted((int(r) for r in done if r != longest), key=lambda r: order[r])
    return [longest] + rest[:requests - 1]


def _err(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Per row: the RMS of ``x - ref`` over the standard deviation of
    ``ref``."""
    return (x - ref).pow(2).mean(-1).sqrt() / ref.std(-1)


def _side() -> Dict[str, list]:
    return {"gaps": [], "err": [], "not_argmax": []}


def compare(run, params, model: dict, prompts, seed: int, plan: dict, device, *,
            logits=reference.logits, tap=None, control: bool = False) -> dict:
    """The judged tokens of the sample, each side's arrays concatenated;
    ``plan`` is the mix's ``check`` (``requests``, ``tokens_each``),
    ``logits`` the model module's.  With ``tap`` the sample is drawn from
    the requests it placed.  Token ids outside the vocabulary are reported
    apart (they have no gap)."""
    te = plan["tokens_each"]
    rids = sample(run, seed, plan["requests"], None if tap is None else tap.placed)
    sides = {"program": _side(), "control": _side() if control else None}
    bad_ids = 0
    for r in rids:
        served = run.tokens[r]
        bad = sum(1 for x in served if not 0 <= x < model["vocab"])
        if bad:
            bad_ids += bad
            continue
        seq = np.concatenate([np.asarray(prompts[r], np.int64),
                              np.asarray(served[:-1], np.int64)])
        toks = torch.from_numpy(seq).to(device)
        judged = torch.as_tensor(served[-te:], device=device).long()
        ref = logits(params, model, toks, len(judged))
        best = ref.max(dim=-1).values
        prog = sides["program"]
        prog["gaps"].append(best - ref.gather(1, judged[:, None])[:, 0])
        if tap is not None:
            held, rows, arg = tap.rows_for(r, len(served), len(judged))
            held = torch.as_tensor(held, device=device)
            prog["err"].append(_err(rows, ref[held]))
            prog["not_argmax"].append(arg != judged[held])
        if control:
            low = logits(params, model, toks, len(judged), fp8=True)
            pick = low.argmax(dim=-1)
            ctl = sides["control"]
            ctl["gaps"].append(best - ref.gather(1, pick[:, None])[:, 0])
            ctl["err"].append(_err(low, ref))
            ctl["not_argmax"].append(torch.zeros_like(pick, dtype=torch.bool))
    out = {"rids": rids, "bad_ids": bad_ids, "control": None}
    for name, side in sides.items():
        if side is not None:
            out[name] = {k: torch.cat(v).cpu().numpy() if v else np.zeros(0)
                         for k, v in side.items()}
    return out


def numbers(cmp: dict, limits: dict, root=spec.ROOT) -> Dict[str, dict]:
    """The numbers compared, each beside its limit, and whether it holds:
    the statistics that the configuration file's ``check`` names, read from
    the program's side, that every sampled token was compared, and that
    none lies outside the vocabulary."""
    prog = cmp["program"]
    rows = {name: {"value": spec.statistic(name, root)(prog), "limit": lim, "rule": "<="}
            for name, lim in limits.items()}
    rows["tokens_compared"] = {"value": int(prog["gaps"].size), "limit": 1, "rule": ">="}
    rows["requests_compared"] = {"value": len(cmp["rids"]), "limit": 1, "rule": ">="}
    rows["token_ids_outside_vocab"] = {"value": int(cmp["bad_ids"]), "limit": 0, "rule": "<="}
    for row in rows.values():
        v, lim = row["value"], row["limit"]
        row["ok"] = v is not None and lim is not None and (
            v <= lim if row["rule"] == "<=" else v >= lim)
    return rows
