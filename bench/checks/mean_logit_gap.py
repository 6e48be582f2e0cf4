"""The mean gap over the judged tokens (``max_logit_gap``'s gaps)."""


def read(cmp):
    g = cmp["gaps"]
    return float(g.mean()) if g.size else None
