"""The benchmark of the PyTorch and CUDA port (`BENCHMARK.json`)."""
