"""prefill_us_per_tok (us/token): the total length of the program's
``engine.admit`` and ``engine.chunk`` spans inside the window over the
unpadded prompt tokens they consumed (their ``tokens``): an admission from
its start to its first token on the host, and each paged prefill chunk.
Read from the program's spans (``bench/spans.py``): only in a traced run."""
from bench import spans

KINDS = ("engine.admit", "engine.chunk")


def read(m):
    sp = spans.read(m)
    if sp is None:
        return None
    tokens = sp.total("tokens", *KINDS)
    return float(sp.lengths(*KINDS).sum()) / 1e3 / tokens if tokens else None
