"""Checkpoints in the JAX package's npz format.

The JAX package saves its whole training state as one npz whose keys are
``jax.tree_util`` path strings joined by ``/`` (socialways_tpu/io/
checkpoint.py:62-167): ``.g_params/['feat_mlp']/[2]/['w']``,
``.d_params/['obsv_lstm']/['w']``, ``.g_ema/['encoder']/['b']``, the optax
Adam state as ``.g_opt/[0]/.count`` (int32) and
``.g_opt/[0]/.mu/['embed']/['w']``, ``.g_opt/[0]/.nu/...`` (the same for
``.d_opt``; an optimizer with an lr schedule adds its schedule count as
``.g_opt/[1]/.count``; under a gradient clip, optax's ``chain(clip,
adam)`` puts an empty state first and the Adam keys one level deeper,
``.g_opt/[1]/[0]/.count``), plus ``__epoch__``, ``__rng__`` (a uint32[2]
JAX key), ``__scale__/*`` and ``__config__`` (the JSON of ``MODEL_CONFIG_FIELDS``).
This module reads and writes those keys as strings, without JAX, so the
two packages read each other's checkpoints.  The port's own random stream
travels beside ``__rng__`` as ``__torch_rng__/<device type>``.

Why the config travels with the weights: an ``--agent-frame --use-social``
checkpoint has the same structure as a plain one, so under the wrong flags
it loads cleanly and serves garbage.  Consumers call
``adopt_checkpoint_config`` before building the model.
"""

from __future__ import annotations

import json
import os
import re
import sys
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from socialways_torch.config import MODEL_CONFIG_FIELDS, TrainConfig
from socialways_torch.data.scale import Scale
from socialways_torch.device import resolve_device
from socialways_torch.engine.train_step import TrainState, init_train_state
from socialways_torch.models.generator import Generator, init_generator

_PATH_ENTRY = re.compile(r"^\[(?:'([^']*)'|(\d+))\]$")


def _jax_path_to_name(path: str) -> str:
    """``['feat_mlp']/[0]/['w']`` -> ``feat_mlp.0.w``."""
    parts = []
    for entry in path.split("/"):
        m = _PATH_ENTRY.match(entry)
        if m is None:
            raise ValueError(f"not a JAX tree path entry: {entry!r} in "
                             f"{path!r}")
        parts.append(m.group(1) if m.group(1) is not None else m.group(2))
    return ".".join(parts)


def _name_to_jax_path(name: str) -> str:
    """``feat_mlp.0.w`` -> ``['feat_mlp']/[0]/['w']``."""
    return "/".join(f"[{p}]" if p.isdigit() else f"['{p}']"
                    for p in name.split("."))


def _flatten_tree(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    if isinstance(tree, Mapping):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree)}
    flat = {}
    for k, v in items:
        flat.update(_flatten_tree(v, f"{prefix}.{k}" if prefix else str(k)))
    return flat


def generator_params_from_jax(tree_or_flat) -> Dict[str, torch.Tensor]:
    """The weight bridge: JAX generator parameters -> a port ``state_dict``.

    Takes either the nested JAX tree (dicts and lists of arrays, e.g.
    ``jax.device_get(init_generator(...))``) or a flat mapping keyed by JAX
    path strings (``"['feat_mlp']/[0]/['w']"``).  The port keeps the JAX
    layout (``w [in, out]``, fused LSTM ``w [in+h, 4h]``), so no array is
    transposed."""
    flat = (tree_or_flat if all(isinstance(k, str) and k.startswith("[")
                                for k in tree_or_flat)
            else None)
    if flat is not None:
        named = {_jax_path_to_name(k): np.asarray(v) for k, v in flat.items()}
    else:
        named = _flatten_tree(tree_or_flat)
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in named.items()}


def load_checkpoint_config(path: str) -> Optional[dict]:
    """The model-defining config embedded in a checkpoint, or None for
    checkpoints that carry none (the CLI flags then decide)."""
    with np.load(path) as data:
        if "__config__" in data.files:
            return json.loads(str(data["__config__"]))
    return None


def adopt_checkpoint_config(cfg: TrainConfig, path: str,
                            warn_stream=None) -> TrainConfig:
    """``cfg`` with the checkpoint's model-defining fields adopted.  A
    requested value that differs from both the default and the checkpoint
    is a contradiction: warn, and use the checkpoint's value."""
    saved = load_checkpoint_config(path)
    if saved is None:
        return cfg
    warn_stream = warn_stream if warn_stream is not None else sys.stderr
    defaults = TrainConfig()
    overrides = {}
    for field, ckpt_val in saved.items():
        cli_val = getattr(cfg, field)
        if cli_val == ckpt_val:
            continue
        if cli_val != getattr(defaults, field):
            print(f"WARNING: requested {field}={cli_val!r} contradicts "
                  f"the checkpoint's {field}={ckpt_val!r}; using the "
                  f"checkpoint's value (the weights were trained with "
                  f"it)", file=warn_stream)
        overrides[field] = ckpt_val
    return cfg.replace(**overrides) if overrides else cfg


def restore_generator(path: str, cfg: TrainConfig, device=None
                      ) -> Tuple[Generator, int, Optional[Scale]]:
    """Load the generator to serve from a JAX-format checkpoint.

    Takes the EMA generator (``.g_ema/...``) when ``cfg.g_ema_decay > 0``
    and the raw one (``.g_params/...``) otherwise, as ``eval_params`` does
    (socialways_tpu/engine/train_step.py:59-62), onto ``device``
    (``None`` = ``cuda``).  Returns ``(generator, epoch, scale)``;
    ``scale`` is None when the checkpoint carries none."""
    prefix = ".g_ema/" if cfg.g_ema_decay > 0 else ".g_params/"
    with np.load(path) as data:
        flat = {k[len(prefix):]: data[k] for k in data.files
                if k.startswith(prefix)}
        epoch = int(data["__epoch__"])
        scale_items = {k.split("/", 1)[1]: float(data[k]) for k in data.files
                       if k.startswith("__scale__/")}
    if not flat:
        raise KeyError(f"checkpoint {path} has no {prefix[:-1]} generator "
                       f"(g_ema_decay={cfg.g_ema_decay})")
    gen = init_generator(cfg, torch.Generator().manual_seed(0), "cpu")
    state = generator_params_from_jax(flat)
    expected = gen.state_dict()
    for k, v in expected.items():
        if k not in state:
            raise KeyError(f"checkpoint missing leaf {prefix}"
                           f"{_name_to_jax_path(k)}")
        if tuple(state[k].shape) != tuple(v.shape):
            raise ValueError(f"checkpoint leaf {prefix}{_name_to_jax_path(k)}"
                             f" has shape {tuple(state[k].shape)}, expected "
                             f"{tuple(v.shape)}")
    gen.load_state_dict(state, strict=True)
    scale = Scale.from_dict(scale_items) if scale_items else None
    return gen.to(resolve_device(device)), epoch, scale


def save_generator_checkpoint(path: str, g_params: Generator, epoch: int,
                              scale: Optional[Scale] = None,
                              cfg: Optional[TrainConfig] = None) -> None:
    """Write the generator in the JAX key format (atomic rename).

    Writes ``.g_params/...``, and the same weights as ``.g_ema/...`` when
    ``cfg.g_ema_decay > 0`` (as at JAX init), plus
    ``__epoch__``, ``__scale__/*`` and ``__config__``: a serving
    checkpoint that ``restore_generator`` and ``load_checkpoint_config``
    read.  ``save_checkpoint`` writes the full training state."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    subtrees = {".g_params/": g_params}
    if cfg is not None and cfg.g_ema_decay > 0:
        subtrees[".g_ema/"] = g_params
    payload = {}
    for prefix, module in subtrees.items():
        for name, t in module.state_dict().items():
            payload[prefix + _name_to_jax_path(name)] = (
                t.detach().cpu().numpy())
    payload["__epoch__"] = np.asarray(epoch, np.int64)
    if scale is not None:
        for k, v in scale.to_dict().items():
            payload[f"__scale__/{k}"] = np.asarray(v)
    if cfg is not None:
        cfg_dict = {f: getattr(cfg, f) for f in MODEL_CONFIG_FIELDS}
        payload["__config__"] = np.asarray(json.dumps(cfg_dict))
    tmp = path + ".tmp.npz"
    np.savez(tmp, **payload)
    os.replace(tmp, path)


_MODULES = (".g_params/", ".d_params/", ".g_ema/")
_OPTS = (".g_opt/", ".d_opt/")
_TORCH_RNG = "__torch_rng__/"


def _opt_prefix(prefix: str, opt) -> str:
    """Where an optimizer's Adam state sits: under ``[1]/`` when the clip
    state comes first."""
    return prefix + ("[1]/" if opt.clipped else "")


def flatten_state(state: TrainState) -> Dict[str, np.ndarray]:
    """The JAX ``TrainState`` leaves of ``state``, keyed as JAX flattens
    them."""
    flat = {}
    modules = {".g_params/": state.g, ".d_params/": state.d,
               ".g_ema/": state.g_ema}
    for prefix, module in modules.items():
        if module is None:
            continue
        for name, t in module.state_dict().items():
            flat[prefix + _name_to_jax_path(name)] = t.detach().cpu().numpy()
    for prefix, opt in zip(_OPTS, (state.g_opt, state.d_opt)):
        prefix = _opt_prefix(prefix, opt)
        flat[f"{prefix}[0]/.count"] = np.asarray(opt.count, np.int32)
        if opt.schedule_count is not None:
            flat[f"{prefix}[1]/.count"] = np.asarray(opt.schedule_count,
                                                     np.int32)
        for moment in ("mu", "nu"):
            for name, t in getattr(opt, moment).items():
                flat[f"{prefix}[0]/.{moment}/{_name_to_jax_path(name)}"] = (
                    t.detach().cpu().numpy())
    return flat


def state_from_flat(flat: Mapping[str, np.ndarray], cfg: TrainConfig,
                     device=None) -> TrainState:
    """A ``TrainState`` for ``cfg`` holding the leaves of ``flat`` (keyed
    as JAX flattens a ``TrainState``); every leaf the model needs must be
    there with its shape."""
    state = init_train_state(cfg, torch.Generator().manual_seed(0), "cpu")

    def take(key: str, like: torch.Tensor) -> torch.Tensor:
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = np.asarray(flat[key])
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"checkpoint leaf {key} has shape "
                             f"{tuple(arr.shape)}, expected "
                             f"{tuple(like.shape)}")
        return torch.from_numpy(np.array(arr, dtype=np.float32))

    modules = {".g_params/": state.g, ".d_params/": state.d,
               ".g_ema/": state.g_ema}
    for prefix, module in modules.items():
        if module is None:
            continue
        module.load_state_dict(
            {name: take(prefix + _name_to_jax_path(name), t)
             for name, t in module.state_dict().items()}, strict=True)
    for prefix, opt in zip(_OPTS, (state.g_opt, state.d_opt)):
        prefix = _opt_prefix(prefix, opt)
        # the schedule's count only where cfg gives the optimizer a
        # schedule; JAX's restore ignores the leaf elsewhere too
        counts = [("count", f"{prefix}[0]/.count")]
        if opt.schedule_count is not None:
            counts.append(("schedule_count", f"{prefix}[1]/.count"))
        for attr, key in counts:
            if key not in flat:
                raise KeyError(f"checkpoint missing leaf {key}")
            setattr(opt, attr, int(flat[key]))
        for moment in ("mu", "nu"):
            tensors = getattr(opt, moment)
            for name, t in tensors.items():
                tensors[name] = take(
                    f"{prefix}[0]/.{moment}/{_name_to_jax_path(name)}", t)
    dev = resolve_device(device)
    for opt in (state.g_opt, state.d_opt):
        for moment in (opt.mu, opt.nu):
            for name in moment:
                moment[name] = moment[name].to(dev)
    for module in (state.g, state.d, state.g_ema):
        if module is not None:
            module.to(dev)
    return state


def train_state_from_jax(tree, cfg: TrainConfig, device=None) -> TrainState:
    """The weight bridge for the whole training state: the numpy leaves of
    a JAX ``TrainState`` (``jax.device_get(state)``: ``g_params``,
    ``d_params``, ``g_opt``/``d_opt`` as optax ``(ScaleByAdamState(count,
    mu, nu), EmptyState() or ScaleByScheduleState(count))``, behind an
    empty clip state under a gradient clip, and ``g_ema``) -> the port's
    state, optimizer moments and counts included."""
    flat = {}
    for field in ("g_params", "d_params", "g_ema"):
        sub = getattr(tree, field)
        if sub is None:
            continue
        for name, v in _flatten_tree(sub).items():
            flat[f".{field}/{_name_to_jax_path(name)}"] = np.asarray(v)
    for field in ("g_opt", "d_opt"):
        opt, prefix = getattr(tree, field), f".{field}/"
        if not hasattr(opt[0], "mu"):       # chain(clip, adam)
            opt, prefix = opt[1], prefix + "[1]/"
        adam, sched = opt[:2]
        flat[f"{prefix}[0]/.count"] = np.asarray(adam.count)
        if "count" in getattr(sched, "_fields", ()):    # not EmptyState
            flat[f"{prefix}[1]/.count"] = np.asarray(sched.count)
        for moment in ("mu", "nu"):
            for name, v in _flatten_tree(getattr(adam, moment)).items():
                flat[f"{prefix}[0]/.{moment}/{_name_to_jax_path(name)}"] = (
                    np.asarray(v))
    return state_from_flat(flat, cfg, device)


def save_checkpoint(path: str, state: TrainState, epoch: int,
                    generator: Optional[torch.Generator] = None,
                    scale: Optional[Scale] = None,
                    cfg: Optional[TrainConfig] = None) -> None:
    """Write the full training state in the JAX npz format (atomic
    rename), readable by socialways_tpu's ``restore_checkpoint``.
    ``__rng__`` is a valid JAX key (PRNGKey(cfg.seed)); the state of
    ``generator``, the port's stream, goes beside it."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    payload = flatten_state(state)
    payload["__epoch__"] = np.asarray(epoch, np.int64)
    seed = cfg.seed if cfg is not None else 0
    payload["__rng__"] = np.asarray([0, seed & 0xFFFFFFFF], np.uint32)
    if generator is not None:
        payload[_TORCH_RNG + generator.device.type] = (
            generator.get_state().numpy())
    if scale is not None:
        for k, v in scale.to_dict().items():
            payload[f"__scale__/{k}"] = np.asarray(v)
    if cfg is not None:
        cfg_dict = {f: getattr(cfg, f) for f in MODEL_CONFIG_FIELDS}
        payload["__config__"] = np.asarray(json.dumps(cfg_dict))
    tmp = path + ".tmp.npz"
    np.savez(tmp, **payload)
    os.replace(tmp, path)


def restore_checkpoint(path: str, cfg: TrainConfig, device=None
                       ) -> Tuple[TrainState, int,
                                  Optional[Tuple[str, torch.Tensor]],
                                  Optional[Scale]]:
    """Restore a full training state written by this port or by the JAX
    package.  Returns ``(state, epoch, rng, scale)``: ``rng`` is
    ``(device type, generator state)`` for a port checkpoint and None for a
    JAX one (whose stream the port cannot continue)."""
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    epoch = int(flat.pop("__epoch__"))
    rng = None
    for k in list(flat):
        if k.startswith(_TORCH_RNG):
            rng = (k[len(_TORCH_RNG):], torch.from_numpy(flat.pop(k)))
    scale_items = {k.split("/", 1)[1]: float(v) for k, v in flat.items()
                   if k.startswith("__scale__/")}
    scale = Scale.from_dict(scale_items) if scale_items else None
    return state_from_flat(flat, cfg, device), epoch, rng, scale
