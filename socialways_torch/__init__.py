"""PyTorch/CUDA port of socialways_tpu for one NVIDIA H100.

The training path (``train --recipe loo``: unrolled LSGAN + InfoGAN steps,
EMA, D instance noise, the gated stall rescue, full-state checkpoints) and
the serving path (checkpoint -> K-sample social rollout -> evaluate /
predict), with the social-attention forward and its backward as
hand-written sm_90a CUDA kernels.  Module names follow ``socialways_tpu``
so each counterpart is easy to find, and every package exports JAX's
``__all__`` names (this one ``TrainConfig``), each loaded with its module
on first use; nothing here imports JAX or the JAX package.
"""

from socialways_torch._lazy import lazy_exports

_EXPORTS = {"TrainConfig": ".config"}
__all__ = list(_EXPORTS)
__getattr__ = lazy_exports(__name__, _EXPORTS)
