"""Carrying state across between the reference and the port.

``state_from_numpy`` takes the reference's state as ``jax.device_get``
returns it — nested dicts of numpy arrays with its ``RouteTable``,
``DispatchState`` and ``RingLog`` dataclasses — and builds the port's
state on a device.  ``state_to_numpy`` goes back: the port's nesting and
dataclasses, with numpy arrays.  Dataclasses are matched by class name, so
this module needs nothing from the reference package.  Unsigned 32-bit
arrays become int64 tensors (the port's representation of uint32);
bfloat16 arrays (``ml_dtypes``, as JAX hands them out) become bfloat16
tensors, and go back as float32 numpy arrays (exact), so this module needs
no ``ml_dtypes`` either.

``params_from_numpy`` carries the reference's model parameters across: the
pytree of :func:`repro.models.model.init_params`, as numpy arrays, becomes
the port's :class:`~repro_torch.models.model.Params` with the stacked
``units`` axis unrolled into one block per layer.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core.routing import RouteTable
from repro_torch.core.scaleout import DispatchState
from repro_torch.core.telemetry import RingLog
from repro_torch.tree import flatten, tree_map

DATACLASSES = {c.__name__: c for c in (RouteTable, DispatchState, RingLog)}

__all__ = ["state_from_numpy", "state_to_numpy", "params_from_numpy",
           "flatten"]


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.uint16).astype(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A copy: the port updates some state in place (the KV cache), and a
    snapshot must not follow it."""
    t = t.detach().cpu()
    return np.array((t.float() if t.dtype == torch.bfloat16 else t).numpy(),
                    copy=True)


def state_from_numpy(tree: Any, device=None) -> Any:
    """The reference's host-side state -> the port's state on ``device``
    (default: the CPU)."""
    if isinstance(tree, dict):
        return {k: state_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(state_from_numpy(v, device) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        cls = DATACLASSES.get(type(tree).__name__)
        if cls is None:
            raise TypeError(f"no port counterpart for "
                            f"{type(tree).__name__}")
        return cls(**{f.name: state_from_numpy(getattr(tree, f.name), device)
                      for f in dataclasses.fields(cls)})
    if isinstance(tree, (np.ndarray, np.generic)):
        return _tensor(tree, device)
    return tree


def state_to_numpy(state: Any) -> Any:
    """The port's state -> the same nesting with numpy arrays (copies,
    on the host)."""
    return tree_map(_to_numpy, state)


def params_from_numpy(cfg, tree: Any, device=None):
    """The reference's parameters (``jax.device_get`` of its pytree:
    ``embed``, ``units`` with leaves stacked over ``n_units``, ``rem``,
    ``final_norm``) -> the port's ``Params`` on ``device`` (default: the
    CPU)."""
    from repro_torch.models.model import Params
    units = {}
    for k, stacked in tree["units"].items():
        leaves = state_from_numpy(stacked, device)
        units[k] = [tree_map(lambda t, u=u: t[u].clone(), leaves)
                    for u in range(cfg.n_units)]
    return Params(cfg, {
        "embed": state_from_numpy(tree["embed"], device),
        "units": units,
        "rem": [state_from_numpy(b, device) for b in tree["rem"]],
        "final_norm": state_from_numpy(tree["final_norm"], device)})
