"""Parallel and chunked execution (counterpart of `tinyvc_tpu/parallel/`)."""
