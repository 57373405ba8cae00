"""CUDA runtime launch calls (kernel and graph launches) that the profiler
records on the host over the stretch, per request."""


def read(trace):
    n = trace.launches()
    return n / trace.n_requests if n and trace.n_requests else None
