"""Data of the port (counterparts of ``transmil_deepgraft_tpu.data``): synthetic
bags, the MIL data module, and tile files (names, decoding, normalization)."""
