"""The benchmark of the PyTorch/CUDA port of TinyVC (`tinyvc_tpu_torch`).

`run.py` runs one cell of `BENCHMARK.json` once; `README.md` says how cells,
configurations, traffic mixes and per-layer metrics are added.
"""
