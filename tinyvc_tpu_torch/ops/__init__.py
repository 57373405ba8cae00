"""kNN retrieval (counterpart of `tinyvc_tpu/ops/retrieval.py`)."""
