"""Stacked models: M models of one architecture held as one module whose
parameters carry a leading member axis, and model code run over them
under ``torch.func.vmap``.

The ensemble (engine/ensemble.py) trains M seeds of one recipe at once.
A stacked module is the solo module with every parameter ``[M, ...]``;
Adam and the EMA update it in place like a solo one.  The model functions
(``models/generator.py``, ``models/discriminator.py``) read a module or
any namespace of the same structure, so ``Members`` runs them for every
member at once: it hands ``vmap`` each stacked module's parameters and
gives the function member m's namespace of them (``module_view``).  Under
``vmap`` every product is a batched product and the social-attention
kernels launch once for all members (their ``vmap`` rule); the outputs
come back with a leading member axis and keep their autograd graph, so a
gradient is taken outside ``vmap`` as for a solo model.
"""

from __future__ import annotations

import copy
from types import SimpleNamespace
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn


def stack_modules(modules: Sequence[nn.Module]) -> nn.Module:
    """One module with ``modules[0]``'s structure whose every parameter is
    the members' parameters stacked on a new leading axis (their
    ``requires_grad`` kept)."""
    out = copy.deepcopy(modules[0])
    params = [dict(m.named_parameters()) for m in modules]
    for name, p in out.named_parameters():
        p.data = torch.stack([ps[name].detach() for ps in params])
    return out


def member_module(stacked: nn.Module, i: int) -> nn.Module:
    """Member ``i`` of a stacked module as a solo module (a copy)."""
    out = copy.deepcopy(stacked)
    for p in out.parameters():
        p.data = p.data[i].clone()
    return out


def module_view(module: nn.Module, tensors: Dict[str, torch.Tensor],
                prefix: str = ""):
    """A namespace with ``module``'s structure whose parameters are
    ``tensors[qualified name]``, as the model functions read a module (a
    list for a ``ModuleList``)."""
    if isinstance(module, nn.ModuleList):
        return [module_view(m, tensors, f"{prefix}{i}.")
                for i, m in enumerate(module)]
    items = {k: tensors[prefix + k]
             for k, _ in module.named_parameters(recurse=False)}
    items.update({k: module_view(c, tensors, f"{prefix}{k}.")
                  for k, c in module.named_children()})
    return SimpleNamespace(**items)


class Deferred(NamedTuple):
    """``fn`` of a member's view of ``module``, taken inside ``vmap``."""
    module: nn.Module
    fn: Callable


class Members:
    """How model code runs: ``m`` None, a plain call on the modules (one
    model); ``m`` members, ``torch.func.vmap`` over the leading member
    axis of the stacked modules' parameters and of the member arguments
    (tensors, or dicts and tuples of them).  Every other tensor the code
    reads (data, closed over) is shared by the members."""

    def __init__(self, m: Optional[int] = None):
        self.m = m

    @property
    def lead(self) -> Tuple[int, ...]:
        """The leading shape a per-member result has: ``(M,)`` or ``()``."""
        return () if self.m is None else (self.m,)

    def defer(self, fn: Callable, module: nn.Module):
        """``fn(module)`` now for one model; inside each member's call for
        members (pass the result among ``__call__``'s modules)."""
        return fn(module) if self.m is None else Deferred(module, fn)

    def __call__(self, fn: Callable, modules: Sequence, *member):
        """``fn(*modules, *member)``; for members each module is member
        m's view (or ``Deferred``'s function of it) and each member
        argument its slice m, and every output gets a leading M."""
        if self.m is None:
            return fn(*modules, *member)
        mods = [d.module if isinstance(d, Deferred) else d for d in modules]
        params = tuple(dict(mod.named_parameters()) for mod in mods)

        def one(params_m, *member_m):
            views = []
            for d, mod, p in zip(modules, mods, params_m):
                view = module_view(mod, p)
                views.append(d.fn(view) if isinstance(d, Deferred) else view)
            return fn(*views, *member_m)
        return torch.func.vmap(one)(params, *member)
