"""Training: losses, masking, optimizers, the train step, checkpoints.

Counterpart of :mod:`mmada_parallel_tpu.training` (the A and M train steps
and ParaRL).
"""
