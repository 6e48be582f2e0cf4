"""device_idle_share (%): the share of the traced window in which nothing
ran on the device, 100 (1 - busy / window), the busy time being the union
of the profiler's device operations (kernels, copies, sets)."""


def read(m):
    if m.trace is None or not m.trace.names:
        return None
    return 100.0 * (1.0 - m.trace.busy_s() / m.trace.window_s)
