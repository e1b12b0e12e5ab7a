"""Console-script shims of the port's CLIs (port of ``cli/_entry.py``).

Each CLI ``main()`` returns its results (metrics dict, written paths, ...) for
programmatic callers and tests.  setuptools-generated wrappers run
``sys.exit(entry())``, so pointing them straight at ``main`` would turn a
successful run into a non-zero exit status (any truthy return value).  These
shims discard the return value and exit 0 on success; exceptions still
propagate as failures. ``pyproject.toml`` does not declare them: the
repository's tests pin every ``[project.scripts]`` entry to the JAX
package's shims. Run a CLI as ``python -m transmil_deepgraft_tpu_torch.cli.<name>``.
"""

from __future__ import annotations

from importlib import import_module


def _run(mod: str) -> int:
    import_module(f"transmil_deepgraft_tpu_torch.cli.{mod}").main()
    return 0


def train() -> int:
    return _run("train")


def visualize() -> int:
    return _run("visualize")


def infer() -> int:
    return _run("infer")


def extract_features() -> int:
    return _run("extract_features")


def sustainability() -> int:
    return _run("sustainability")


def export_metrics() -> int:
    return _run("export_metrics")


def export_model() -> int:
    return _run("export_model")


def serve() -> int:
    return _run("serve")


def pretrain() -> int:
    return _run("pretrain")
