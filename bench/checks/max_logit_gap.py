"""The widest gap over the judged tokens: how far each served token's logit
lies below the reference's best at its position (0 where it is the
reference's argmax)."""


def read(cmp):
    g = cmp["gaps"]
    return float(g.max()) if g.size else None
