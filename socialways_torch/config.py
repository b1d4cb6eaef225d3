"""Configuration of the serving and training paths.

Every field of ``socialways_tpu/config.py:TrainConfig``, with its
defaults (reference train.py:19-84), plus ``MODEL_CONFIG_FIELDS`` — the
fields a checkpoint carries because they define what its weights mean
(socialways_tpu/io/checkpoint.py:46-59).  ``data_file`` is accepted and
read by nothing, as in JAX.  Values the port does not implement (a master
``dtype`` other than float32, compute dtypes other than float32 and
bfloat16) and ``mesh_shape``, a JAX field that JAX reads nowhere (a mesh
is ``Trainer(mesh=)`` and ``train --mesh``), are refused by
``check_supported``, which names the field, instead of silently training
another model.

``model`` selects the architecture: ``"socialWays"`` (every field above)
or ``"sgan"``, Social GAN with its pooling module (Gupta et al., CVPR 2018,
arXiv:1803.10892; ``models/sgan.py``), served only (``simulate``,
``predict``, ``evaluate``).  SGAN reads ``embedding_dim``,
``encoder_h_dim``, ``decoder_h_dim``, ``mlp_dim``, ``bottleneck_dim`` and
``noise_mix`` beside the shared ``noise_len``, ``noise_dist``,
``max_scene_size``, ``compute_dtype``, ``n_past`` and ``n_next``; its
pool's inner width is ``SGAN_POOL_WIDTH``, fixed in the published code.
Social Ways' own fields (``SOCIAL_WAYS_ONLY``) stay at their defaults
under SGAN.
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
#: The model fields of Social GAN, which its checkpoints embed beside
#: ``MODEL_CONFIG_FIELDS`` (a Social Ways checkpoint's ``__config__`` keeps
#: JAX's fields alone, so the JAX package still reads it).
SGAN_CONFIG_FIELDS = ("model", "embedding_dim", "encoder_h_dim",
                      "decoder_h_dim", "mlp_dim", "bottleneck_dim",
                      "noise_mix")
#: Social Ways' model fields that Social GAN reads nowhere: a value other
#: than the default would be ignored without a word, so it is refused
SOCIAL_WAYS_ONLY = ("hidden_size", "n_lstm_layers", "num_social_features",
                    "social_feature_size", "decoder", "n_latent_codes",
                    "latent_code_type", "mb_std", "pac", "spectral_norm",
                    "use_social", "agent_frame")
#: the models ``TrainConfig.model`` names
MODELS = ("socialWays", "sgan")
#: the hidden width of SGAN's pair MLP (``PoolHiddenNet``'s 512, fixed in
#: sgan/models.py)
SGAN_POOL_WIDTH = 512


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    # ---- data ----
    dataset: str = "hotel"
    data_file: str = ""              # read by nothing, as in JAX
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
    latent_dim: int = 10             # --latent-dim (read by nothing, as in
                                     # JAX and the reference)
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

    # ---- Social GAN (model="sgan", models/sgan.py; sgan's flag names)
    model: str = "socialWays"
    embedding_dim: int = 16
    encoder_h_dim: int = 32
    decoder_h_dim: int = 32
    mlp_dim: int = 64
    bottleneck_dim: int = 32
    noise_mix: str = "global"        # one noise vector a scene

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
    # the parameter and optimizer (master) dtype: float32 only (JAX's
    # socialways_tpu/config.py:230; check_supported refuses the others)
    dtype: str = "float32"
    compute_dtype: str = "float32"
    model_dir: str = "trained_models"
    dump_dir: str = ""               # prediction dumps each test interval
    lnr_model: str = "cv"            # the dumps' linear baseline: cv | kalman
    # JAX's loop knobs (socialways_tpu/config.py:236, 279): the port runs
    # the CUDA kernels on the card whatever use_pallas says; with
    # epoch_on_device every step of an epoch on the card is a replay of a
    # captured CUDA graph (engine/graphed.py), and False runs the steps
    # eagerly from the host (JAX's per-chunk host loop).  The CPU and a
    # mesh always run eagerly
    use_pallas: bool = False
    epoch_on_device: bool = True

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

    # ---- read by no code of either package (check_supported refuses it)
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
    if cfg.model not in MODELS:
        raise NotImplementedError(f"model={cfg.model!r} is not ported to "
                                  "socialways_torch")
    if cfg.model == "sgan":
        _check_sgan(cfg)
        return
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
        ("dtype", cfg.dtype != "float32"),
        ("compute_dtype", cfg.compute_dtype not in ("float32", "bfloat16")),
        ("mesh_shape", cfg.mesh_shape is not None),
    ]
    for field, bad in unsupported:
        if bad:
            raise NotImplementedError(
                f"{field}={getattr(cfg, field)!r} is not ported to "
                "socialways_torch yet")


def checkpoint_fields(cfg: TrainConfig) -> dict:
    """The model-defining fields a checkpoint of ``cfg`` embeds."""
    names = MODEL_CONFIG_FIELDS + (SGAN_CONFIG_FIELDS
                                   if cfg.model == "sgan" else ())
    return {f: getattr(cfg, f) for f in names}


def _check_sgan(cfg: TrainConfig) -> None:
    """What the SGAN generator is built for: the pooling module, the
    global noise mix, Gaussian noise (sgan's ``noise_type gaussian``), a
    decoder state wider than the noise, and none of Social Ways' own
    fields set."""
    defaults = TrainConfig()
    unsupported = [
        ("noise_mix", cfg.noise_mix != "global"),
        ("noise_dist", cfg.noise_dist != "gaussian"),
        ("noise_len", not 0 < cfg.noise_len < cfg.decoder_h_dim),
        ("dtype", cfg.dtype != "float32"),
        ("compute_dtype", cfg.compute_dtype not in ("float32", "bfloat16")),
        ("mesh_shape", cfg.mesh_shape is not None),
    ] + [(f, getattr(cfg, f) != getattr(defaults, f))
         for f in SOCIAL_WAYS_ONLY]
    for field, bad in unsupported:
        if bad:
            raise NotImplementedError(
                f"{field}={getattr(cfg, field)!r} is not built for "
                "model='sgan'")


def check_trainable(cfg: TrainConfig) -> None:
    """Raise for a model the port serves but does not train: SGAN's
    discriminator, losses and the pooling's backward are not ported."""
    if cfg.model != "socialWays":
        raise NotImplementedError(
            f"model={cfg.model!r} is served only (simulate, predict, "
            "evaluate): its training is not ported to socialways_torch")
