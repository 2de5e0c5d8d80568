"""The benchmark's plain reference: DYffusion's backbones, sampler, loss
and optimizer in plain PyTorch (float32, TF32 off), the comparisons that
decide ``correct``, and the counters of the work (FLOPs, bytes).

Nothing here imports the system under test or JAX: it is frozen with the
benchmark, and takes from the system only its outputs, to judge them.
"""
