"""Carrying state across between the reference and the port.

``state_from_numpy`` takes the reference's state as ``jax.device_get``
returns it — nested dicts of numpy arrays with its ``RouteTable``,
``DispatchState`` and ``RingLog`` dataclasses — and builds the port's
state on a device.  ``state_to_numpy`` goes back: the port's nesting and
dataclasses, with numpy arrays.  Dataclasses are matched by class name, so
this module needs nothing from the reference package.  Unsigned 32-bit
arrays become int64 tensors (the port's representation of uint32).
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

__all__ = ["state_from_numpy", "state_to_numpy", "flatten"]


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


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
    """The port's state -> the same nesting with numpy arrays (copied to
    the host)."""
    return tree_map(lambda t: t.detach().cpu().numpy(), state)
