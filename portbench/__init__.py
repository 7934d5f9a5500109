"""The benchmark of the PyTorch and CUDA port `fibers_tpu_torch`: see
`portbench/run.py`."""
