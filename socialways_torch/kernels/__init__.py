"""Hand-written CUDA kernels (csrc/) with their wrappers and build.
JAX's ``__all__``: ``social_attention`` is the module
``kernels/social_attention.py``, which called is the size-aware dispatch
function (JAX exports the function under that name), and
``social_attention_fused`` its kernel pair; each loaded on first use, and
no kernel is built before its first launch."""

from socialways_torch._lazy import lazy_exports

_EXPORTS = {
    "social_attention": ".social_attention",
    "social_attention_fused": ".social_attention",
}
__all__ = list(_EXPORTS)
__getattr__ = lazy_exports(__name__, _EXPORTS)
