"""PyTorch/CUDA port of socialways_tpu for one NVIDIA H100.

The serving path (checkpoint -> K-sample social rollout -> evaluate /
predict) with the social-attention forward as a hand-written sm_90a CUDA
kernel.  Module names follow ``socialways_tpu`` so each counterpart is easy
to find; nothing here imports JAX or the JAX package.
"""
