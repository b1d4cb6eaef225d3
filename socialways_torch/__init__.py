"""PyTorch/CUDA port of socialways_tpu for one NVIDIA H100.

The training path (``train --recipe loo``: unrolled LSGAN + InfoGAN steps,
EMA, D instance noise, the gated stall rescue, full-state checkpoints) and
the serving path (checkpoint -> K-sample social rollout -> evaluate /
predict), with the social-attention forward and its backward as
hand-written sm_90a CUDA kernels.  Module names follow ``socialways_tpu``
so each counterpart is easy to find; nothing here imports JAX or the JAX
package.
"""
