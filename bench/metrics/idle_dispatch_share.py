"""idle_dispatch_share (%): the share of the traced window in which no
device operation runs while the host is inside a model step's dispatch (a
``step.prefill`` or ``step.decode`` span, in none of its ``sync`` spans).
The device's operations and their union as ``device_idle_share`` takes
them; the program's spans on the same clock (``bench/spans.py``)."""
from bench import spans


def read(m):
    if m.trace is None or not m.trace.names:
        return None
    sp = spans.read(m)
    if sp is None:
        return None
    return 100.0 * spans.idle_split(sp, m.trace)["dispatch"] / 1e9 / m.trace.window_s
