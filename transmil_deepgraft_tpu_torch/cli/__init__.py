"""Command-line entry points of the port: ``serve`` (the HTTP daemon),
``infer`` (slide folders -> probabilities and top-k tiles) and
``export_model`` (the bundles the daemon serves)."""
