"""portbench: the benchmark of the PyTorch and CUDA port
(`electrocardio_panorama_tpu_torch`) on NVIDIA GPUs. `run.py` is the command;
see BENCHMARK.json at the repository's root for its cells and metrics."""
