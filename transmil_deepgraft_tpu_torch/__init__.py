"""PyTorch/CUDA port of ``transmil_deepgraft_tpu`` for NVIDIA Hopper (H100).

The JAX package beside this one is the reference: every module here mirrors a
module there by name, and the tests hold each one to its JAX counterpart on
the same inputs and weights. This package imports ``torch``, ``numpy`` and,
to decode tiles, PIL (never ``jax``, ``flax`` or ``transmil_deepgraft_tpu``).

The TPU kernels on the serving path are CUDA C++: the fused TransLayer's
``_k1``/``_k2`` in ``csrc/translayer.cu``, and the int8 ResNet50's
``_stage_kernel``/``_entry_kernel`` in ``csrc/qstage.cu``. Each source is
compiled with ``nvcc`` at first use into ``build/torch_kernels/`` and called
through ``ctypes``.

The command-line entry points are ``cli.export_model``, ``cli.serve``,
``cli.infer`` and ``cli.train``. Slide tiles decode with the JAX package's
threaded libjpeg loader, of which ``native/tileloader.cpp`` is a copy that
``g++`` builds into ``build/native/`` at first use, or with PIL where it
cannot build; the bag store's ``native/bagstore.cpp`` is built the same way.

Entry points take ``device=None`` (``--device`` on the command line), which
means ``"cuda"``; without a card they raise unless ``device="cpu"`` is passed.
"""

__version__ = "0.1.0"
