"""Hand-written Hopper kernels of the port, their plain PyTorch versions
(``ref.py``) and the device dispatch (``ops.py``)."""
