"""The generator and the discriminator.  JAX's ``__all__``, each name
loaded with its module on first use, and ``init_model``, the one place
that maps ``cfg.model`` to its generator."""

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


def init_model(cfg, generator=None, device=None):
    """The generator ``cfg.model`` names, drawn from ``generator`` (a CPU
    ``torch.Generator``) on ``device``: Social Ways'
    (``generator.init_generator``) or Social GAN's (``sgan.init_sgan``)."""
    if cfg.model == "sgan":
        from socialways_torch.models.sgan import init_sgan
        return init_sgan(cfg, generator, device)
    from socialways_torch.models.generator import init_generator
    return init_generator(cfg, generator, device)
