"""The generator and the discriminator.  JAX's ``__all__``, each name
loaded with its module on first use."""

from socialways_torch._lazy import lazy_exports

_EXPORTS = {
    "encode_observation": ".generator",
    "generator_rollout": ".generator",
    "init_generator": ".generator",
    "social_context": ".generator",
    "discriminator_apply": ".discriminator",
    "init_discriminator": ".discriminator",
    "restore_linear_only": ".discriminator",
}
__all__ = list(_EXPORTS)
__getattr__ = lazy_exports(__name__, _EXPORTS)
