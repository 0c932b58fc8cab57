"""The benchmark of the PyTorch and CUDA port (`repro_torch`): one cell of
BENCHMARK.json a run, driven by the files found by name under this
folder.  See run.py."""
