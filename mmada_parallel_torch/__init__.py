"""MMaDA-Parallel on PyTorch and CUDA: the port of :mod:`mmada_parallel_tpu`.

The JAX package stays the reference; this package keeps its module names so
each module's counterpart is easy to find, and is held against it by the
``tests/test_torch_*.py`` files.  Plain tensor code is eager PyTorch with an
explicit ``device``; the Pallas kernels (the fused-RoPE packed attention,
its q-only form for the feature cache, the BLHD flash attention and the
prefix-bounds attention of the training task masks) are hand-written CUDA
kernels for Hopper under ``csrc/``, built with ``nvcc`` at their first CUDA
call and bound with ``ctypes`` (:mod:`mmada_parallel_torch.ops._cuda`), each
behind an autograd Function whose backward recomputes the plain chain.

The port imports nothing of the JAX package, not even its framework-free
host modules: it keeps its own copies of them at the same relative paths
(:mod:`.tokens`, :mod:`.config`, :mod:`.utils.image`, :mod:`.utils.logging`,
the A and M trainers' :mod:`.data` with the C++ readers under ``native/``
(built with ``g++`` at first use), :mod:`.eval_scorers` and
:mod:`.data.parabench`), held against their originals by
``tests/test_torch_host_modules.py`` and ``tests/test_torch_data_m.py``.  ``tests/test_torch_no_jax.py`` runs
its paths with ``jax`` and ``mmada_parallel_tpu`` blocked.
"""

__version__ = "0.1.0"

from mmada_parallel_torch import tokens  # noqa: F401
