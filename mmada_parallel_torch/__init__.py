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

Framework-free host code is imported from the JAX package rather than copied:
:mod:`mmada_parallel_tpu.tokens` and :mod:`mmada_parallel_tpu.utils.image`
(neither imports ``jax``), and inside the CLIs' ``main`` only
:mod:`mmada_parallel_tpu.config` (variant M; it needs ``yaml``) and
:mod:`mmada_parallel_tpu.data` / :mod:`mmada_parallel_tpu.utils.logging`
(the A trainer's data pipeline and metric logging).  Nothing else of
``mmada_parallel_tpu`` is imported here.
"""

__version__ = "0.1.0"

from mmada_parallel_tpu import tokens  # noqa: F401
