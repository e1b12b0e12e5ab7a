"""Data of the port (counterparts of ``transmil_deepgraft_tpu.data``): synthetic bags."""
