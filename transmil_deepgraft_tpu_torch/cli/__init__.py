"""Command-line entry points of the port: ``serve`` (the HTTP daemon),
``infer`` (slide folders -> probabilities and top-k tiles),
``export_model`` (the bundles the daemon serves), ``train`` (a YAML
config -> checkpoints, test metrics and result CSVs) and
``extract_features`` (tile folders -> per-slide feature files)."""
