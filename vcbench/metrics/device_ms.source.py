"""Device milliseconds a request in `decode_infer`'s range outside
`filter_infer`'s: SourceNet and the DSP source (kernels A and B)."""


def read(trace):
    s = trace.range_device_s("decoder") - trace.range_device_s("unet")
    return 1e3 * s / trace.n_requests if s > 0 else None
