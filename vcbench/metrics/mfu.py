"""The whole request's share of the card's peak: the operations of every
layer (spectrogram, encoder, energy, match and the DSP source in fp32;
SourceNet's trunk and the U-Net in the profile's dtype) each over the peak
of its type, summed over the stretch's requests, over the stretch's wall
time, in percent."""

from vcbench.harness import counts

LAYERS = ("spectrogram", "encoder", "energy", "retrieval", "source", "unet")


def read(trace):
    w = trace.window_s
    if w <= 0 or not trace.device:
        return None
    return 100.0 * sum(counts.peak_s(trace.layer_calls(layer)) for layer in LAYERS) / w
