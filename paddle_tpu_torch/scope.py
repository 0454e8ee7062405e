"""Runtime Scope: name -> torch.Tensor store on one device.

Port of the JAX package's ``scope.py`` (reference: paddle/fluid/framework/
scope.h:46).  Only persistable values (parameters, and in the training
slice optimizer state) live in a scope.  A scope carries the
``torch.device`` its tensors live on: given at construction, or bound
by the first executor that runs with it.  ``set`` takes a numpy array
(or a tensor) and puts it on that device.  As the reference's scope, one
has a parent (``get`` and ``find_var`` read through it) and kids, and
``find_var(name).get_tensor()`` views a var's tensor.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

__all__ = ["Scope", "global_scope", "scope_guard"]


def to_numpy(t) -> np.ndarray:
    """Host copy of a tensor; bfloat16 comes back as float32 (numpy has
    no bfloat16)."""
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def host_copy(x) -> np.ndarray:
    """A host array that nothing else writes: a tensor, on the card or the
    CPU, is copied out (a CPU tensor's ``numpy()`` would share its
    memory); a numpy array is taken as it is."""
    if isinstance(x, torch.Tensor):
        t = x.detach()
        return to_numpy(t if t.is_cuda else t.clone())
    return np.asarray(x)


class _TensorView:
    """A scope var's tensor as the reference's LoDTensor binding shows it
    (``scope.find_var(n).get_tensor()``): ``np.array(view)``, ``set``
    and ``shape``."""

    def __init__(self, scope: "Scope", name: str):
        self._scope = scope
        self._name = name

    def __array__(self, dtype=None, copy=None):
        arr = to_numpy(self._scope.vars[self._name])
        return arr.astype(dtype) if dtype is not None else arr

    def set(self, value, place=None):
        """Store ``value`` on the scope's device; a scope with no device
        yet takes ``place``'s."""
        if place is not None:
            from paddle_tpu_torch.framework import device_of

            self._scope.bind_device(device_of(place))
        self._scope.set(self._name, value)

    def shape(self):
        return list(np.shape(self._scope.vars[self._name]))


class _VarView:
    def __init__(self, scope: "Scope", name: str):
        self._scope = scope
        self._name = name

    def get_tensor(self) -> _TensorView:
        return _TensorView(self._scope, self._name)


class Scope:
    """A name -> tensor map on one device, with a parent it reads through
    (``get``, ``find_var``) and kids (``new_scope``), as the reference's
    hierarchical scope.  A kid inherits its parent's device."""

    def __init__(self, parent: Optional["Scope"] = None, *, device=None):
        self.vars: Dict[str, Any] = {}
        self.parent = parent
        self.kids = []
        if device is None and parent is not None:
            device = parent.device
        self.device: Optional[torch.device] = (
            torch.device(device) if device is not None else None)

    def new_scope(self) -> "Scope":
        kid = Scope(self)
        self.kids.append(kid)
        return kid

    def drop_kids(self):
        self.kids = []

    def local_var_names(self):
        return list(self.vars.keys())

    def _owner(self, name: str) -> Optional["Scope"]:
        s = self
        while s is not None:
            if name in s.vars:
                return s
            s = s.parent
        return None

    def find_var(self, name: str) -> Optional[_VarView]:
        """The var ``name`` here or in an ancestor, or None."""
        owner = self._owner(name)
        return _VarView(owner, name) if owner is not None else None

    def var(self, name: str) -> _VarView:
        """The var ``name``, made here (holding nothing yet) if no scope
        up the chain has it."""
        owner = self._owner(name)
        if owner is None:
            self.vars[name] = None
            owner = self
        return _VarView(owner, name)

    def bind_device(self, device: torch.device) -> None:
        """Pin this scope to ``device`` (first use), or check that it
        already is: one scope never mixes devices."""
        device = torch.device(device)
        if self.device is None:
            self.device = device
        elif self.device != device:
            raise ValueError(
                "scope holds tensors on %s; cannot run it on %s (use a "
                "separate Scope per device)" % (self.device, device))

    def get(self, name: str):
        owner = self._owner(name)
        return owner.vars[name] if owner is not None else None

    def set(self, name: str, value):
        """Store ``value`` (numpy array or tensor) on the scope's device."""
        if self.device is None:
            raise RuntimeError(
                "scope has no device yet: construct it with Scope(device=...) "
                "or run an executor with it first")
        if isinstance(value, torch.Tensor):
            self.vars[name] = value.to(self.device)
        else:
            # the scope owns its copy: later writes to the caller's array
            # (or a read-only view of another framework's buffer) cannot
            # reach it
            arr = np.require(np.asarray(value), requirements=["C", "W"])
            self.vars[name] = torch.from_numpy(arr).to(self.device, copy=True)


_global_scope = Scope()
_scope_stack = [_global_scope]


def global_scope() -> Scope:
    return _scope_stack[-1]


class scope_guard:
    def __init__(self, scope: Scope):
        self._scope = scope

    def __enter__(self):
        _scope_stack.append(self._scope)
        return self._scope

    def __exit__(self, *exc):
        _scope_stack.pop()
