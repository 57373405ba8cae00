"""Conversion pipeline (counterpart of `tinyvc_tpu/infer/`)."""
