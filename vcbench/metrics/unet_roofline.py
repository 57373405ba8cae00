"""The U-Net's least time at the request's shapes and the profile's dtype
(the frame-rate 1x1s, the stem, decimations and down chains, interpolations
and up chains with the folded output conv) over the device time of
`filter_infer`'s range, in percent."""

from vcbench.harness import counts


def read(trace):
    s = trace.range_device_s("unet")
    return 100.0 * counts.least_s(trace.layer_calls("unet")) / s if s > 0 else None
