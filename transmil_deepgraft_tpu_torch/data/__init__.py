"""Data of the port (counterparts of ``transmil_deepgraft_tpu.data``): synthetic
bags, per-slide feature bags from disk and the native bag store, spatial
feature volumes, the MIL data module and its prefetch pipeline, tile files
(names, decoding, normalization, augmentation), JPEG tile-folder bags,
legacy image bags, Camelyon16, whole-slide grid patches, feature
extraction and the feature-file tools."""
