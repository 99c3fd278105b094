"""Adam and Momentum with the fused flat-group update.

Port of ``simple_tensorflow_tpu/train/optimizers.py:AdamOptimizer`` (:367)
and ``MomentumOptimizer`` (:314) on their fused paths
(``_maybe_build_fused_update``, lowered by ``_lower_fused_adam`` :189 and
``_lower_fused_momentum`` :241), as ``torch.optim.Optimizer`` subclasses:

- parameters are grouped by ``(param dtype, update dtype)`` in order of
  first occurrence (``_build_groups`` :78); the update dtype is f32 for
  bf16 parameters and the parameter's own dtype otherwise;
- each group keeps ONE flat slot per slot name in the update dtype
  (``_flat_slot_layout`` :89): Adam's ``m`` and ``v`` (the JAX
  ``Adam/fused_m_g{i}`` / ``fused_v_g{i}`` variables), Momentum's
  ``momentum`` (``Momentum/fused_momentum_g{i}``);
- Adam keeps f32 ``beta1_power``/``beta2_power``, decayed after every
  group's update, and launches one fused Adam kernel per group
  (:func:`..ops.kernels.fused_update.adam_update`) with ``alpha = lr *
  sqrt(1 - beta2_power) / (1 - beta1_power)`` formed on the device from
  the CURRENT beta powers;
- Momentum launches one fused Momentum kernel per group
  (:func:`..ops.kernels.fused_update.momentum_update`) with f32 device
  scalars ``lr`` and ``mu`` (``_fused_hypers`` :135: the Python floats
  converted to the update dtype).

Where the JAX lowering concatenates every parameter and gradient of a
group each step and splits the result (:146-150, :184-186), here the
parameters and their ``.grad`` live as views into one flat buffer per
group, so the kernel updates them in place and autograd accumulates into
the flat gradient: no concatenate or split runs. ``zero_grad`` zeroes the
flat gradients and keeps the views. Code that replaces a parameter's
``.data`` or ``.grad`` (``nn.Module.zero_grad()``, which sets ``.grad`` to
None; ``module.to(...)``, ``module.to(memory_format=...)``) cuts it off
from the flat buffers: ``step`` raises then, rather than update a stale
copy.
"""

from __future__ import annotations

import torch

from ..ops.kernels.fused_update import adam_update, momentum_update

_LOW_PRECISION = (torch.bfloat16, torch.float16)


def update_dtype(dtype):
    """The slot/update dtype of a parameter dtype (``slot_creator.
    update_dtype``): f32 for low-precision floats."""
    return torch.float32 if dtype in _LOW_PRECISION else dtype


def build_groups(params):
    """``{(param dtype, update dtype): [param, ...]}`` in order of first
    occurrence."""
    groups = {}
    for p in params:
        groups.setdefault((p.dtype, update_dtype(p.dtype)), []).append(p)
    return groups


class FlatGroup:
    """One ``(param dtype, update dtype)`` group: the flat parameter and
    gradient buffers every member is a view into, and one flat slot in the
    update dtype per name of ``slot_names`` (``group.slots[name]``, also
    ``group.<name>``). ``owner`` names the optimizer in errors."""

    def __init__(self, params, ud, slot_names, owner):
        self.params = list(params)
        self.sizes = [p.numel() for p in self.params]
        self.owner = owner
        n = sum(self.sizes)
        dtype, device = self.params[0].dtype, self.params[0].device
        self.p = torch.empty(n, dtype=dtype, device=device)
        self.g = torch.zeros(n, dtype=dtype, device=device)
        self.slots = {name: torch.zeros(n, dtype=ud, device=device)
                      for name in slot_names}
        self.offsets = []
        off = 0
        with torch.no_grad():
            for p, size in zip(self.params, self.sizes):
                view = self.p[off:off + size].view_as(p)
                view.copy_(p)
                p.data = view
                p.grad = self.g[off:off + size].view_as(p)
                self.offsets.append(off)
                off += size

    def __getattr__(self, name):
        slots = self.__dict__.get("slots", {})
        if name in slots:
            return slots[name]
        raise AttributeError(name)

    def __len__(self):
        return self.p.numel()

    def check_views(self):
        """Raise unless every member's data and ``.grad`` are still its
        views into the flat buffers."""
        elem = self.p.element_size()
        for i, (p, off) in enumerate(zip(self.params, self.offsets)):
            at = off * elem
            if p.data_ptr() != self.p.data_ptr() + at or p.grad is None or \
                    p.grad.data_ptr() != self.g.data_ptr() + at:
                raise RuntimeError(
                    f"{self.owner}: parameter {i} of the {self.p.dtype} "
                    "group no longer views the flat parameter and gradient "
                    "buffers (its .data or .grad was replaced, e.g. by "
                    "nn.Module.zero_grad(), which sets .grad to None); use "
                    "the optimizer's zero_grad()")


class _FlatOptimizer(torch.optim.Optimizer):
    """What both optimizers share: the flat groups with their named
    slots, ``zero_grad`` on the flat gradients, and the learning rate (a
    float or a callable returning an f32 scalar tensor on the parameters'
    device, read once per step, before anything is updated)."""

    slot_names = ()

    def __init__(self, params, defaults, learning_rate):
        params = [p for p in params if p.requires_grad]
        if not params:
            raise ValueError(f"{type(self).__name__} got no trainable "
                             "parameters")
        super().__init__(params, defaults)
        self._lr = learning_rate
        self.device = params[0].device
        self._lr_t = None if callable(learning_rate) else torch.tensor(
            float(learning_rate), dtype=torch.float32, device=self.device)
        self.flat_groups = [
            FlatGroup(ps, ud, self.slot_names, type(self).__name__)
            for (_, ud), ps in build_groups(params).items()]

    def zero_grad(self, set_to_none: bool = False):
        for grp in self.flat_groups:
            grp.g.zero_()

    def _learning_rate(self):
        return self._lr() if self._lr_t is None else self._lr_t

    def _check_views(self):
        for grp in self.flat_groups:
            grp.check_views()


class AdamOptimizer(_FlatOptimizer):
    """Adam over flat groups (module docstring). ``update`` is the
    flat-group update each step runs per group: the kernel wrapper
    :func:`..ops.kernels.fused_update.adam_update`, or a function of the
    same signature such as its plain version."""

    slot_names = ("m", "v")

    def __init__(self, params, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, update=adam_update):
        super().__init__(params, dict(lr=learning_rate, beta1=beta1,
                                      beta2=beta2, epsilon=epsilon),
                         learning_rate)
        self._beta1 = float(beta1)
        self._beta2 = float(beta2)
        self._epsilon = float(epsilon)
        self.update = update
        self.beta1_power = torch.tensor(self._beta1, dtype=torch.float32,
                                        device=self.device)
        self.beta2_power = torch.tensor(self._beta2, dtype=torch.float32,
                                        device=self.device)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        self._check_views()
        lr = self._learning_rate()
        b1p, b2p = self.beta1_power, self.beta2_power
        for grp in self.flat_groups:
            ud = grp.m.dtype
            alpha = lr.to(ud) * torch.sqrt(1 - b2p.to(ud)) / (1 - b1p.to(ud))
            self.update(grp.p, grp.m, grp.v, grp.g, alpha, beta1=self._beta1,
                        beta2=self._beta2, eps=self._epsilon)
        b1p.mul_(self._beta1)
        b2p.mul_(self._beta2)
        return loss


class MomentumOptimizer(_FlatOptimizer):
    """Momentum (``use_nesterov=True``: Nesterov) over flat groups, one
    flat ``momentum`` slot per group (module docstring). ``momentum`` is
    a float, held as an f32 device scalar. ``update`` is the flat-group
    update each step runs per group: the kernel wrapper
    :func:`..ops.kernels.fused_update.momentum_update`, or a function of
    the same signature such as its plain version."""

    slot_names = ("momentum",)

    def __init__(self, params, learning_rate, momentum, use_nesterov=False,
                 update=momentum_update):
        super().__init__(params, dict(lr=learning_rate, momentum=momentum,
                                      use_nesterov=use_nesterov),
                         learning_rate)
        self.use_nesterov = bool(use_nesterov)
        self.update = update
        self.mu = torch.tensor(float(momentum), dtype=torch.float32,
                               device=self.device)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        self._check_views()
        lr = self._learning_rate()
        for grp in self.flat_groups:
            ud = grp.momentum.dtype
            self.update(grp.p, grp.momentum, grp.g, lr.to(ud),
                        self.mu.to(ud), use_nesterov=self.use_nesterov)
        return loss
