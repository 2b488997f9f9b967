"""The benchmark of gaussian_process_tpu_torch, the PyTorch and CUDA port:
matrix-free GP training steps and posterior queries on one H100, driven by
the cells of ``BENCHMARK.json``. See ``gpbench/README.md``."""
