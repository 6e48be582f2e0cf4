"""decode_tick_ms_p50 (ms): the median wall of the engine ticks inside the
window that carried no admission and no prefill chunk, the ticks grouped
from the token stream (``records.Run.ticks``)."""
import numpy as np


def read(m):
    walls, carried = m.run.ticks()
    w = walls[~carried]
    return float(np.median(w)) * 1e3 if w.size else None
