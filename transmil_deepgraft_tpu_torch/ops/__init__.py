"""Tensor ops of the port (counterparts of ``transmil_deepgraft_tpu.ops``)."""
