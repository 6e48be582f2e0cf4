"""decode_dispatch_ms_p50 (ms): the median self time of the program's
``step.decode`` spans inside the window, their length less the ``sync``
spans inside them: the host's time to enqueue one decode step.  Read from
the program's spans (``bench/spans.py``): only in a traced run."""
import numpy as np

from bench import spans


def read(m):
    sp = spans.read(m)
    if sp is None or not sp.of("step.decode").any():
        return None
    return float(np.median(sp.self_times("step.decode"))) / 1e6
