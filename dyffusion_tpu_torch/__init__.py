"""dyffusion_tpu_torch: the PyTorch/CUDA port of dyffusion_tpu.

Trains the two DYffusion stages through the run registry and its CLI
(``python -m dyffusion_tpu_torch.train``), and serves the folded, bf16,
MC-dropout ensemble cold sampler over two ``Unet`` backbones, on an NVIDIA
H100, with the linear attention as a hand-written CUDA kernel; also the
baselines (time-conditioned, simultaneous, DDPM, LDM-DDPM, MCVD over any
backbone, NCSN++ and its SPADE variant included). A trained run's
sampler exports as one ``torch.export`` artifact (``serving.export_run``,
``python -m dyffusion_tpu_torch.serving``) with the kernels inside as
``torch.library`` ops, served by ``serving.load_exported`` with no model
code. Mirrors the JAX package's layout and module names; imports neither
JAX nor ``dyffusion_tpu``.

Seeds: a served request draws every random tensor (dropout masks, noise)
from one generator seeded by the request's seed, in a fixed order, so the
same seed gives the same answer, eagerly (``serving.build_predict_fn``)
and in the artifact, on one device (``utils/rng.py``).

Numerics: the package sets no global torch flags, except where a config
asks: ``run_experiment`` applies ``matmul_precision`` (torch's f32 matmul
precision; cuDNN TF32 off for 'highest', on otherwise). TF32
(``torch.backends.cuda.matmul.allow_tf32``, default False, and
``torch.backends.cudnn.allow_tf32``, default True) touches only f32 work on
the GPU; on the bf16 serving path that is the small f32 time-embedding and
FiLM MLPs, under the matmul flag. ``chip_smoke.py`` turns both off so that
its f32 GPU-vs-CPU comparison runs full f32.
"""

__version__ = "0.1.0"
