"""Encoder and DDSP decoder (counterpart of `tinyvc_tpu/models/`)."""
