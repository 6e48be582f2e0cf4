"""The judged tokens that are not the argmax of the program's own logits at
their step, as the logits tap (``bench/tap.py``) kept them.  Exact, so its
limit is 0: it catches a token altered between the step and the stream,
which no gap statistic can tell from rounding on a model whose gaps swing
(a router that flips on bf16 rounding)."""


def read(cmp):
    v = cmp["not_argmax"]
    return int(v.sum()) if v.size else None
