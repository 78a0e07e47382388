"""fpng_tpu_torch's benchmark: BENCHMARK.json's cells, driven by data
(pngbench/run.py)."""
