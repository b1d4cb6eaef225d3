"""Generator checkpoints in the JAX package's npz format.

The JAX package saves its whole training state as one npz whose keys are
``jax.tree_util`` path strings joined by ``/`` (socialways_tpu/io/
checkpoint.py:62-105): ``.g_params/['feat_mlp']/[2]/['w']``,
``.g_ema/['encoder']/['b']``, plus ``__epoch__``, ``__rng__``,
``__scale__/*`` and, since its round 5, ``__config__`` (the JSON of
``MODEL_CONFIG_FIELDS``).  Serving needs only the generator: this module
reads those keys as strings, without JAX, and ignores ``.d_params``,
``.g_opt``, ``.d_opt`` and ``__rng__``.

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
    ``__epoch__``, ``__scale__/*`` and ``__config__``.  This port's
    ``restore_generator`` and ``load_checkpoint_config`` read it; the JAX
    package's full-state ``restore_checkpoint`` cannot until the training
    slice also writes the discriminator and the optimizer states."""
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
