"""Device milliseconds a request inside the spectrogram's and the
encoder's ranges (`serving_spectrogram`, kernel G or `torch.fft`;
`Encoder.infer`)."""


def read(trace):
    s = trace.range_device_s("spectrogram", "encoder")
    return 1e3 * s / trace.n_requests if s > 0 else None
