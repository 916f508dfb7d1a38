"""vct_tpu_torch — the PyTorch/CUDA port of ``vct_tpu`` for NVIDIA Hopper.

The JAX package ``vct_tpu`` is the reference this package is held against:
the modules keep the reference ``state_dict`` key names, so weights move
between the two through ``vct_tpu_torch.convert``. The greedy decode step
runs on CUDA kernels written by hand for ``sm_90a`` (``csrc/``), each beside
a plain PyTorch version of the same function (``ops/decode_kernels.py``).

This package imports ``torch`` and never ``jax``. It shares the framework-free
host modules of ``vct_tpu``: ``config``, ``text.tokenizer``,
``data.collate.fit_time_axis`` and ``evalcap``.
"""

__version__ = "0.1.0"
