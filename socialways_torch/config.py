"""Configuration of the serving and training paths.

The fields the port reads, with the defaults of
``socialways_tpu/config.py:TrainConfig`` (reference train.py:19-84), plus
``MODEL_CONFIG_FIELDS`` — the fields a checkpoint carries because they
define what its weights mean (socialways_tpu/io/checkpoint.py:46-59).
The JAX fields the port does not implement yet (a mesh, compute dtypes
other than float32 and bfloat16) are fields here too, so that
``check_supported`` can name them when a caller sets one instead of
silently training another model.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

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
    dataset: str = "hotel"
    n_past: int = 8
    n_next: int = 12
    batch_size: int = 256            # greedy scene-batch accumulation cap

    # ---- optimisation (reference defaults) ----
    n_epochs: int = 1000
    lr_g: float = 1e-4
    lr_d: float = 1e-3
    adam_b1: float = 0.9
    adam_b2: float = 0.999

    # ---- GAN step (socialways_tpu/config.py:36-198) ----
    n_unrolling_steps: int = 1
    use_info_loss: bool = True
    loss_info_w: float = 0.5
    # info-weight ramp: loss_info_w -> loss_info_w_end over
    # loss_info_w_steps G steps, then held (0 = constant)
    loss_info_w_end: float = 0.0
    loss_info_w_steps: int = 0
    d_restore: str = "full"          # "full" | "reference" | "none"
    # D instance noise on the prediction inputs of every D evaluation,
    # annealed linearly to 0 over d_input_noise_steps GAN steps (0 =
    # constant, -1 = the whole planned run, resolved by the Trainer) and
    # clamped from below by d_input_noise_floor
    d_input_noise: float = 0.0
    d_input_noise_steps: int = 0
    d_input_noise_floor: float = 0.0

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
    test_interval: int = 5           # epochs between eval runs
    save_interval: int = 50          # epochs between checkpoints

    # ---- learning-rate schedules (socialways_tpu/config.py): staircase
    # exponential decay and linear warmup for both optimizers; the d_*
    # fields override the shared ones for D
    lr_decay_rate: float = 1.0
    lr_decay_steps: int = 0
    d_lr_decay_rate: float = 1.0
    d_lr_decay_steps: int = 0
    lr_warmup_steps: int = 0
    d_lr_warmup_steps: int = 0

    # ---- runtime ----
    seed: int = 0
    compute_dtype: str = "float32"
    model_dir: str = "trained_models"
    dump_dir: str = ""               # prediction dumps each test interval
    lnr_model: str = "cv"            # the dumps' linear baseline: cv | kalman

    # ---- the other GAN-step variants (socialways_tpu/config.py:36-198)
    grad_clip: float = 0.0           # global-norm clip before Adam (0 = off)
    # the D phase runs on every k-th G step; after d_update_every_switch G
    # steps k becomes d_update_every_end (0 = no switch)
    d_update_every: int = 1
    d_update_every_end: int = 0
    d_update_every_switch: int = 0
    use_l2_loss: bool = False
    use_variety_loss: bool = False
    loss_l2_w: float = 0.5           # weight of the l2 and variety losses
    variety_k: int = 20              # rollouts of the min-over-K variety loss
    r1_gamma: float = 0.0            # R1 penalty on D's real-data gradient
    ms_weight: float = 0.0           # mode seeking: w / (r + 1e-5)
    ds_weight: float = 0.0           # diversity hinge: w max(0, tau - d/dz)
    ds_tau: float = 1.0
    ds_k: int = 2                    # draws the diversity terms pair over
    # the D phase sees a no-grad rollout; G recomputes it under grad
    serial_rollout: bool = False
    # checkpoint each LSTM and decode step (recomputed in the backward)
    remat_steps: bool = False
    # exact gradient accumulation over this many scene-aligned micro-chunks
    grad_accum: int = 1
    # > 0: a static bound on rows per scene (ids sorted and contiguous), so
    # the social attention scans scene windows only (0 = unknown)
    max_scene_size: int = 0

    # ---- JAX knobs not ported yet (check_supported names them)
    mesh_shape: Optional[int] = None

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)

    @property
    def decoder_input(self) -> int:
        return self.hidden_size + self.social_feature_size + self.noise_len


def check_supported(cfg: TrainConfig) -> None:
    """Raise for a model this port does not implement yet.

    A checkpoint or flag can select one; serving or training it as the
    float32 single-device model instead would silently be a different run
    (the failure socialways_tpu/io/checkpoint.py:11-19 warns about)."""
    if cfg.n_lstm_layers != 1:
        raise ValueError(
            "n_lstm_layers must be 1: the reference's decoder wiring only "
            "supports a single encoder layer")
    if cfg.d_restore not in ("full", "reference", "none"):
        raise ValueError(f"d_restore must be full, reference or none, got "
                         f"{cfg.d_restore!r}")
    unsupported = [
        ("decoder", cfg.decoder not in ("fc", "lstm")),
        ("latent_code_type",
         cfg.latent_code_type not in ("continuous", "categorical")),
        ("noise_dist", cfg.noise_dist not in ("uniform", "gaussian")),
        ("compute_dtype", cfg.compute_dtype not in ("float32", "bfloat16")),
        ("mesh_shape", cfg.mesh_shape is not None),
    ]
    for field, bad in unsupported:
        if bad:
            raise NotImplementedError(
                f"{field}={getattr(cfg, field)!r} is not ported to "
                "socialways_torch yet")
