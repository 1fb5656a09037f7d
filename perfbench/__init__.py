"""The benchmark of the PyTorch and CUDA port's codec plane
(`garage_tpu_torch`); `run.py` runs one cell once."""
