"""The plain reference that decides ``correct``: plain PyTorch and NumPy.

It imports nothing of the port, of the JAX package or of JAX, and takes
nothing the port made: it derives the quantized network, the head's
parameters in its own layout and the optimizer's steps again from the
inputs the benchmark hands to both sides.
"""
