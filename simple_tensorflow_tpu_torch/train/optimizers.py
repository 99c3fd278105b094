"""Optimizers with the fused flat-group update.

The graph optimizers of ``simple_tensorflow_tpu/train/optimizers.py``:
``GradientDescentOptimizer`` (:294), whose update is one ``AssignSub``
chain per variable; ``MomentumOptimizer`` (:314) and ``AdamOptimizer``
(:367) on their fused paths (``_maybe_build_fused_update`` :338, :422):
one ``FusedMomentumUpdate`` or ``FusedAdamUpdate`` op over per-group
flat slot variables with the JAX names (``Momentum/Momentum/
fused_momentum_g0``, ``Adam/Adam/fused_m_g0``; ``_build_groups`` :78,
``_flat_slot_layout`` :89), lowered to one Momentum or Adam kernel launch
per group (``_lower_fused_momentum`` :241-265, ``_lower_fused_adam``
:189-238). Where those lowerings concatenate the group's parameters and
split the result (``_split_write_params`` :184), the Session's store keeps
each parameter as a view into one flat buffer per group, built at the
first update and rebuilt only after a load replaced a member (an assign
copies into it), and the kernel updates it in place; the hyperparameters
(``lr``, ``mu``, Adam's ``alpha``) stay device tensors the kernels read
through pointers, so the step can be captured. Momentum's per-variable
path (``_apply_dense`` :326, with per-variable slots) is built where JAX
builds it: under ``stf.kernels`` mode ``"off"``, or for a subclass that
overrides ``_apply_dense``. Left out of the graph optimizers: Adam's
per-variable path (mode ``"off"`` raises) and the other optimizers.

The eager ``FlatAdam`` and ``FlatMomentum`` are the same fused paths of
``AdamOptimizer`` and ``MomentumOptimizer`` (:314, ``_lower_fused_momentum``
:241) as ``torch.optim.Optimizer`` subclasses for the port's ``nn.Module``
trainers:

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

from .. import kernels
from ..framework import dtypes as dtypes_mod
from ..framework import graph as ops_mod
from ..framework import op_registry
from ..framework.errors import InvalidArgumentError
from ..ops import array_ops, math_ops, state_ops
from ..ops import variables as variables_mod
from ..ops.fused_ops import using_plain_versions
from ..ops.kernels.fused_update import (adam_update, adam_update_plain,
                                        momentum_update,
                                        momentum_update_plain)
from .optimizer import Optimizer, _var_key
from .optimizer import update_dtype as _ud

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


class FlatAdam(_FlatOptimizer):
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


class FlatMomentum(_FlatOptimizer):
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


# -- graph optimizers --------------------------------------------------------

def _store_name(var):
    return var._ref.op.attrs["var_name"]


def _c(value, var):
    """A hyperparameter in the variable's update dtype."""
    return ops_mod.convert_to_tensor(value, dtype=_ud(var))


def _g(grad, var):
    ud = _ud(var)
    return math_ops.cast(grad, ud) if grad.dtype.base_dtype != ud else grad


def _back(x, var):
    d = var.dtype.base_dtype
    return math_ops.cast(x, d) if x.dtype.base_dtype != d else x


def _np_prod(xs):
    n = 1
    for x in xs:
        n *= int(x)
    return n


def _build_groups(pairs):
    """``{(param dtype, update dtype): [(grad, var), ...]}`` by first
    occurrence."""
    groups = {}
    for grad, var in pairs:
        groups.setdefault((var.dtype.base_dtype, _ud(var)), []).append(
            (grad, var))
    return groups


def _fused_hypers(groups, *values):
    """One constant per (hyperparameter, group), in the group's update
    dtype (``_fused_hypers`` :135)."""
    return [ops_mod.convert_to_tensor(value, dtype=ud)
            for value in values for (_pdt, ud) in groups]


def _flat_slot_layout(opt, slot_names, groups):
    """The per-group flat slot variables (``{name}/fused_{slot}_g{i}``)
    and their per-variable view tensors, as the JAX package builds them.
    Returns ``{slot_name: [flat var names]}`` and the groups' parameter
    names."""
    layout = {sn: [] for sn in slot_names}
    group_params = []
    for gi, ((_pdt, ud), pairs) in enumerate(groups.items()):
        sizes = [_np_prod(v.shape.as_list()) for _, v in pairs]
        n = sum(sizes)
        for sn in slot_names:
            ck = (sn, gi, n, ud.name, tuple(_var_key(v) for _, v in pairs))
            flat = opt._flat_slot_cache.get(ck)
            if flat is None:
                flat = variables_mod.Variable(
                    array_ops.zeros([n], dtype=ud), trainable=False,
                    name=f"{opt._name}/fused_{sn}_g{gi}")
                opt._flat_slot_cache[ck] = flat
                opt._fused_slot_vars.append(flat)
                off = 0
                views = opt._slot_views.setdefault(sn, {})
                for (_, v), sz in zip(pairs, sizes):
                    views[_var_key(v)] = array_ops.reshape(
                        array_ops.slice(flat._ref, [off], [sz]),
                        [int(d) for d in v.shape.as_list()])
                    off += sz
            layout[sn].append(_store_name(flat))
        group_params.append(tuple(_store_name(v) for _, v in pairs))
    return layout, group_params


def flat_group(ctx, names):
    """The flat buffer the store entries ``names`` are views into, in
    order; built (one copy) when an entry is not such a view, e.g. at the
    first update or after a load replaced it. The store entries become
    views into it (new addresses: the store's version moves on, which a
    compiled step refuses), so an in-place update of the buffer updates
    them. A value of ``names`` staged earlier in the run is committed
    first: the in-place update is the one write made mid-run."""
    ctx.commit(names)
    cache = ctx.session._flat_groups
    vals = [ctx.read_var(n) for n in names]
    flat = cache.get(names)
    if flat is not None:
        elem, off = flat.element_size(), 0
        ok = True
        for v in vals:
            if v.data_ptr() != flat.data_ptr() + off * elem or \
                    not v.is_contiguous() or v.dtype != flat.dtype:
                ok = False
                break
            off += v.numel()
        if ok and off == flat.numel():
            return flat
    if ctx.compiled:
        raise InvalidArgumentError(
            None, None, f"the flat buffer of {names[:3]}... is rebuilt "
            "inside a compiled step; its address must stay across replays")
    flat = torch.cat([v.detach().reshape(-1) for v in vals])
    off = 0
    for n, v in zip(names, vals):
        ctx.store.set(n, flat[off:off + v.numel()].view(v.shape))
        off += v.numel()
    cache[names] = flat
    return flat


def _group_grads(grads, n, dtype):
    """One group's gradients concatenated in the parameters' dtype: the
    kernels take them so and widen them themselves (JAX widens before the
    call: the same values, bf16 -> f32 being exact)."""
    return torch.cat([g.reshape(-1) for g in grads[:n]]).to(dtype)


def _lower_fused_adam(ctx, op, inputs):
    """One Adam kernel launch per group over the flat parameters, the flat
    ``m``/``v`` slots and the concatenated gradients, in place; then the
    beta powers decay (staged: committed when the run ends), after every
    group's update. The in-place update is the last op of every optimizer
    plan, and the one write a run makes before it ends. A dry run (the
    warm-up of ``ExecutionPlan.compile``) updates copies."""
    attrs = op.attrs
    n_groups = len(attrs["group_params"])
    lrs = inputs[:n_groups]
    grads = inputs[n_groups:]
    beta1, beta2, eps = attrs["beta1"], attrs["beta2"], attrs["epsilon"]
    b1p = ctx.read_var(attrs["beta1_power"], op)
    b2p = ctx.read_var(attrs["beta2_power"], op)
    update = adam_update_plain if using_plain_versions() else adam_update
    lo = 0
    with torch.no_grad():
        for gi, pnames in enumerate(attrs["group_params"]):
            ud = dtypes_mod.as_dtype(attrs["group_ud"][gi]).torch_dtype
            alpha = lrs[gi].to(ud) * torch.sqrt(1 - b2p.to(ud)) \
                / (1 - b1p.to(ud))
            p_flat = flat_group(ctx, tuple(pnames))
            g_flat = _group_grads(grads[lo:], len(pnames), p_flat.dtype)
            lo += len(pnames)
            m = ctx.read_var(attrs["group_m"][gi], op)
            v = ctx.read_var(attrs["group_v"][gi], op)
            if ctx.dry:
                p_flat, m, v = p_flat.clone(), m.clone(), v.clone()
            update(p_flat, m, v, g_flat, alpha, beta1=beta1, beta2=beta2,
                   eps=eps)
        for name, beta in ((attrs["beta1_power"], beta1),
                           (attrs["beta2_power"], beta2)):
            cur = ctx.read_var(name, op)
            ctx.write_var(name, cur * torch.full((), beta, dtype=cur.dtype,
                                                 device=cur.device))
    return []


op_registry.register(
    "FusedAdamUpdate", lower=_lower_fused_adam,
    effects=op_registry.Effects(reads=("var_name",), writes=("var_name",)),
    in_place=True)


def _lower_fused_momentum(ctx, op, inputs):
    """One Momentum kernel launch per group over the flat parameters, the
    flat ``momentum`` slot and the concatenated gradients, in place, with
    the group's f32 ``lr`` and ``mu`` constants as device scalars (as
    :func:`_lower_fused_adam`: the last op of the plan; a dry run updates
    copies)."""
    attrs = op.attrs
    n_groups = len(attrs["group_params"])
    lrs = inputs[:n_groups]
    mus = inputs[n_groups:2 * n_groups]
    grads = inputs[2 * n_groups:]
    nesterov = bool(attrs["use_nesterov"])
    update = (momentum_update_plain if using_plain_versions()
              else momentum_update)
    lo = 0
    with torch.no_grad():
        for gi, pnames in enumerate(attrs["group_params"]):
            p_flat = flat_group(ctx, tuple(pnames))
            g_flat = _group_grads(grads[lo:], len(pnames), p_flat.dtype)
            lo += len(pnames)
            acc = ctx.read_var(attrs["group_momentum"][gi], op)
            if ctx.dry:
                p_flat, acc = p_flat.clone(), acc.clone()
            update(p_flat, acc, g_flat, lrs[gi], mus[gi],
                   use_nesterov=nesterov)
    return []


op_registry.register(
    "FusedMomentumUpdate", lower=_lower_fused_momentum,
    effects=op_registry.Effects(reads=("var_name",), writes=("var_name",)),
    in_place=True)


class GradientDescentOptimizer(Optimizer):
    """(ref: python/training/gradient_descent.py)."""

    def __init__(self, learning_rate, use_locking=False,
                 name="GradientDescent"):
        super().__init__(use_locking, name)
        self._learning_rate = learning_rate

    def _apply_dense(self, grad, var):
        grad = _g(grad, var)
        lr = _c(self._call_if_callable(self._learning_rate), var)
        return state_ops.assign_sub(var._ref, _back(lr * grad, var)).op


class MomentumOptimizer(Optimizer):
    """(ref: python/training/momentum.py): one ``FusedMomentumUpdate`` op
    over flat ``momentum`` slots, or under ``stf.kernels`` mode ``"off"``
    (or in a subclass overriding :meth:`_apply_dense`) the per-variable
    chains ``acc = mu * acc + g; var -= lr * acc`` (Nesterov: ``lr * (g +
    mu * acc)``) in the update dtype."""

    def __init__(self, learning_rate, momentum, use_locking=False,
                 name="Momentum", use_nesterov=False):
        super().__init__(use_locking, name)
        self._learning_rate = learning_rate
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _create_slots(self, var_list):
        for v in var_list:
            self._zeros_slot(v, "momentum", self._name)

    def _apply_dense(self, grad, var):
        grad = _g(grad, var)
        mom = self.get_slot(var, "momentum")
        lr = _c(self._call_if_callable(self._learning_rate), var)
        mu = _c(self._call_if_callable(self._momentum), var)
        new_acc = state_ops.assign(mom._ref, mu * mom._ref + grad)
        if self._use_nesterov:
            update = lr * (grad + mu * new_acc)
        else:
            update = lr * new_acc
        return state_ops.assign_sub(var._ref, _back(update, var)).op

    def _maybe_build_fused_update(self, grads_and_vars):
        if kernels.current_mode() == "off" or \
                type(self)._apply_dense is not MomentumOptimizer._apply_dense:
            return None
        pairs = [(g, v) for g, v in grads_and_vars if g is not None]
        if not pairs:
            return None
        groups = _build_groups(pairs)
        layout, group_params = _flat_slot_layout(self, ("momentum",), groups)
        inputs = (_fused_hypers(
            groups, self._call_if_callable(self._learning_rate),
            self._call_if_callable(self._momentum))
            + [g for pairs_g in groups.values() for g, _ in pairs_g])
        all_params = [p for grp in group_params for p in grp]
        g = ops_mod.get_default_graph()
        return g.create_op(
            "FusedMomentumUpdate", inputs,
            attrs={"var_name": all_params + layout["momentum"],
                   "group_params": tuple(group_params),
                   "group_momentum": tuple(layout["momentum"]),
                   "group_ud": tuple(ud.name for (_p, ud) in groups),
                   "use_nesterov": bool(self._use_nesterov)},
            name="fused_momentum_update", output_specs=[])


class AdamOptimizer(Optimizer):
    """(ref: python/training/adam.py) on the fused path: one
    ``FusedAdamUpdate`` op over flat slots."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, use_locking=False, name="Adam"):
        super().__init__(use_locking, name)
        self._lr = learning_rate
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._beta1_power = None
        self._beta2_power = None

    def _maybe_build_fused_update(self, grads_and_vars):
        if kernels.current_mode() == "off":
            raise NotImplementedError(
                "AdamOptimizer's per-variable path (stf.kernels mode 'off') "
                "is not ported")
        if any(isinstance(h, ops_mod.Tensor) or callable(h)
               for h in (self._beta1, self._beta2, self._epsilon)):
            raise NotImplementedError("AdamOptimizer with tensor beta1, "
                                      "beta2 or epsilon is not ported")
        pairs = [(g, v) for g, v in grads_and_vars if g is not None]
        if not pairs:
            return None
        if self._beta1_power is None:
            self._beta1_power = variables_mod.Variable(
                float(self._beta1), trainable=False,
                name=self._name + "/beta1_power")
            self._beta2_power = variables_mod.Variable(
                float(self._beta2), trainable=False,
                name=self._name + "/beta2_power")
        groups = _build_groups(pairs)
        layout, group_params = _flat_slot_layout(self, ("m", "v"), groups)
        inputs = (_fused_hypers(groups, self._call_if_callable(self._lr))
                  + [g for pairs_g in groups.values() for g, _ in pairs_g])
        all_params = [p for grp in group_params for p in grp]
        b1p = _store_name(self._beta1_power)
        b2p = _store_name(self._beta2_power)
        g = ops_mod.get_default_graph()
        return g.create_op(
            "FusedAdamUpdate", inputs,
            attrs={"var_name": (all_params + layout["m"] + layout["v"]
                                + [b1p, b2p]),
                   "group_params": tuple(group_params),
                   "group_m": tuple(layout["m"]),
                   "group_v": tuple(layout["v"]),
                   "group_ud": tuple(ud.name for (_p, ud) in groups),
                   "beta1_power": b1p, "beta2_power": b2p,
                   "beta1": float(self._beta1), "beta2": float(self._beta2),
                   "epsilon": float(self._epsilon)},
            name="fused_adam_update", output_specs=[])
