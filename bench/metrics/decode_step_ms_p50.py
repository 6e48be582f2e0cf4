"""decode_step_ms_p50 (ms): the median length of the program's
``step.decode`` spans inside the window, from the decode step's call to its
tokens on the host, in every tick (those with an admission too).  Read from
the program's spans (``bench/spans.py``): only in a traced run."""
import numpy as np

from bench import spans


def read(m):
    sp = spans.read(m)
    if sp is None:
        return None
    w = sp.lengths("step.decode")
    return float(np.median(w)) / 1e6 if w.size else None
