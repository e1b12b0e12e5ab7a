"""Training of the port (counterparts of ``transmil_deepgraft_tpu.train``)."""
