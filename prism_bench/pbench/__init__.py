"""The benchmark harness of the PyTorch port (see ``prism_bench/run.py``)."""
