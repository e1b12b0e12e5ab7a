"""Data of the port (counterparts of ``transmil_deepgraft_tpu.data``): synthetic
bags, per-slide feature bags from disk and the native bag store, the MIL data
module, and tile files (names, decoding, normalization)."""
