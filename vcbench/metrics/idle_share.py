"""The share of the stretch's wall time in which no operation ran on the
device: 1 - (union of device operation intervals) / window, in percent."""


def read(trace):
    w = trace.window_s
    return 100.0 * (1.0 - trace.busy_s() / w) if w > 0 and trace.device else None
