"""Signal processing of the conversion path (counterpart of `tinyvc_tpu/dsp/`)."""
