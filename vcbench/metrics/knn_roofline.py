"""The kNN match's least time (the fp32 similarity product 2*B*T*N*C, the
source and dictionary read once, the matched frames written once) over the
device time of `serving_match_features`' range, in percent."""

from vcbench.harness import counts


def read(trace):
    s = trace.range_device_s("retrieval")
    return 100.0 * counts.least_s(trace.layer_calls("retrieval")) / s if s > 0 else None
