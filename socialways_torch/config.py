"""Configuration of the serving path.

The fields this slice reads, with the defaults of
``socialways_tpu/config.py:TrainConfig`` (reference train.py:19-84), plus
``MODEL_CONFIG_FIELDS`` — the fields a checkpoint carries because they
define what its weights mean (socialways_tpu/io/checkpoint.py:46-59).
"""

from __future__ import annotations

import dataclasses

#: Fields that define the model FUNCTION; checkpoints embed them.
MODEL_CONFIG_FIELDS = (
    "n_past", "n_next",
    "hidden_size", "n_lstm_layers", "num_social_features",
    "social_feature_size", "noise_len", "decoder",
    "n_latent_codes", "latent_code_type", "noise_dist",
    "mb_std", "pac", "spectral_norm", "g_ema_decay",
    "use_social", "agent_frame",
)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    # ---- data ----
    n_past: int = 8
    n_next: int = 12
    batch_size: int = 256            # greedy scene-batch accumulation cap

    # ---- architecture ----
    hidden_size: int = 64
    n_lstm_layers: int = 1
    num_social_features: int = 3
    social_feature_size: int = 64
    noise_len: int = 32
    decoder: str = "fc"
    n_latent_codes: int = 2
    latent_code_type: str = "continuous"
    noise_dist: str = "uniform"      # U(0,1), reference train.py:473
    mb_std: bool = False
    pac: int = 1
    spectral_norm: bool = False
    g_ema_decay: float = 0.0         # > 0: serve the EMA generator
    use_social: bool = False
    agent_frame: bool = False

    # ---- evaluation ----
    n_gen_samples: int = 20

    # ---- runtime ----
    seed: int = 0
    compute_dtype: str = "float32"

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)

    @property
    def decoder_input(self) -> int:
        return self.hidden_size + self.social_feature_size + self.noise_len


def check_supported(cfg: TrainConfig) -> None:
    """Raise for a model this port does not implement yet.

    A checkpoint or flag can select one; serving it with the FC/continuous/
    uniform/float32 generator instead would silently be a different model
    (the failure socialways_tpu/io/checkpoint.py:11-19 warns about)."""
    if cfg.n_lstm_layers != 1:
        raise ValueError(
            "n_lstm_layers must be 1: the reference's decoder wiring only "
            "supports a single encoder layer")
    unsupported = [
        ("decoder", cfg.decoder != "fc"),
        ("latent_code_type", cfg.latent_code_type != "continuous"),
        ("noise_dist", cfg.noise_dist != "uniform"),
        ("compute_dtype", cfg.compute_dtype != "float32"),
        ("pac", cfg.pac != 1),
        ("mb_std", bool(cfg.mb_std)),
        ("spectral_norm", bool(cfg.spectral_norm)),
    ]
    for field, bad in unsupported:
        if bad:
            raise NotImplementedError(
                f"{field}={getattr(cfg, field)!r} is not ported to "
                "socialways_torch yet")
