"""Carry weights and training state into the port.

- :func:`load_session_variables` loads a JAX graph's variable values (by
  store name: the model variables, Adam's flat ``m``/``v`` slots, the beta
  powers, ``global_step``) into a port ``stf.Session`` built from the same
  user code.

- :func:`load_stfz` reads a checkpoint written by the JAX package's
  ``train.Saver`` (``<prefix>.stfz``, an npz whose keys are variable paths
  with ``|`` for ``/``, beside ``<prefix>.index.json``) with numpy alone,
  as ``simple_tensorflow_tpu/train/saver.py:load_checkpoint_values``
  (:77-99) reads it. bf16 variables are stored as raw 2-byte values with
  ``"dtype": "bfloat16"`` in the index; they are widened to f32 exactly.
- :func:`params_from_jax` maps JAX variable names
  (``causal_lm/shared_embedding``, ``causal_lm/decoder/layer_{i}/
  {self_attn/{q,k,v,out},ffn/{in,out}}/{kernel,bias}``,
  ``…/ln1|ln3/{gamma,beta}``) to a
  :class:`..models.transformer.DecoderStack` ``state_dict``. Dense kernels
  are ``(in, out)`` on both sides, and in the compute dtype (bf16 under
  bf16 training, as the JAX graph creates them).
- :func:`load_training_state` maps the rest of a JAX training checkpoint
  onto a trainer: ``global_step``, Adam's ``beta1_power``/``beta2_power``
  and the flat slots ``fused_m_g{i}``/``fused_v_g{i}``
  (``train/optimizers.py:104-106``), one per ``(param dtype, update
  dtype)`` group in the same order; and, from the index's ``host_state``
  (:func:`load_host_state`), the session's RNG run counter, so a resumed
  trainer draws the JAX session's next dropout masks.
- :func:`init_params` makes numpy-seeded weights of the same shapes and
  initializers as the JAX model, so the card can run without JAX.
- :func:`seq2seq_params_from_jax` and :func:`init_seq2seq_params` do the
  same for the encoder-decoder (``transformer/encoder/...``,
  ``transformer/decoder/...`` with ``cross_attn``), a
  :class:`..models.transformer.Seq2SeqStack` ``state_dict``.

ResNet (:mod:`.models.resnet`): :func:`resnet_params_from_jax` maps
``resnet/...`` variables to a :class:`..models.resnet.ResNet`
``state_dict`` (conv kernels HWIO -> OIHW), :func:`load_resnet_training_
state` carries the global step and the flat Momentum slots
``Momentum/fused_momentum_g{i}`` (each conv kernel's segment transposed
alike), and :func:`init_resnet_params` draws numpy-seeded weights from the
JAX model's initializers.
"""

from __future__ import annotations

import json
import os
import re

import numpy as np
import torch

from .models.transformer import TransformerConfig

def _prefix(prefix: str) -> str:
    return prefix[:-len(".stfz")] if prefix.endswith(".stfz") else prefix


def load_host_state(prefix: str) -> dict:
    """The ``host_state`` of a checkpoint's index (``{"rng_run_counter":
    …, …}``, ``client/session.py:snapshot_host_state``), or ``{}``."""
    index = _prefix(prefix) + ".index.json"
    if not os.path.exists(index):
        return {}
    with open(index) as f:
        return json.load(f).get("host_state") or {}


def load_stfz(prefix: str) -> dict:
    """``{variable_name: ndarray}`` from a ``.stfz`` checkpoint."""
    prefix = _prefix(prefix)
    index = prefix + ".index.json"
    tensors = {}
    if os.path.exists(index):
        with open(index) as f:
            tensors = json.load(f).get("tensors", {})
        sharded = [k for k, meta in tensors.items()
                   if meta.get("sharded_layout")]
        if sharded:
            raise NotImplementedError(
                f"per-shard checkpoint entries {sharded[:3]} are not read "
                "by the port yet; save from a single-device session")
    out = {}
    with np.load(prefix + ".stfz", allow_pickle=False) as data:
        for key in data.files:
            name = key.replace("|", "/")
            value = data[key]
            if tensors.get(name, {}).get("dtype") == "bfloat16":
                value = bf16_to_f32(value)
            elif value.dtype.kind == "V":
                raise ValueError(f"{name}: raw {value.dtype} values without "
                                 "a dtype in the checkpoint index")
            out[name] = value
    return out


def bf16_to_f32(raw: np.ndarray) -> np.ndarray:
    """Widen raw bfloat16 bits (any 2-byte dtype) to f32, exactly: the
    bf16 bits are the high half of the f32 bits."""
    bits = raw.view(np.uint16).astype(np.uint32) << 16
    return bits.view(np.float32)


def _layer_shapes(out: dict, base: str, cfg: TransformerConfig, attns,
                  lns) -> None:
    """One layer's parameters: the attention Denses of each of ``attns``,
    the FFN, then the LayerNorms ``lns``."""
    d, ff = cfg.d_model, cfg.d_ff
    dense = [(sub, name) for sub in attns
             for name in ("q", "k", "v", "out")]
    for sub, name in dense + [("ffn", "in"), ("ffn", "out")]:
        shape = {"in": (d, ff), "out": (ff, d)}[name] \
            if sub == "ffn" else (d, d)
        out[f"{base}.{sub}.{name}.kernel"] = shape
        out[f"{base}.{sub}.{name}.bias"] = (shape[1],)
    for ln in lns:
        out[f"{base}.{ln}.gamma"] = (d,)
        out[f"{base}.{ln}.beta"] = (d,)


def _shapes(cfg: TransformerConfig) -> dict:
    """Port parameter name -> shape of the causal LM."""
    out = {"shared_embedding": (cfg.vocab_size, cfg.d_model)}
    for i in range(cfg.num_layers):
        _layer_shapes(out, f"decoder.layer_{i}", cfg, ("self_attn",),
                      ("ln1", "ln3"))
    return out


def _seq2seq_shapes(cfg: TransformerConfig) -> dict:
    """Port parameter name -> shape of the encoder-decoder."""
    out = {"shared_embedding": (cfg.vocab_size, cfg.d_model)}
    for i in range(cfg.num_layers):
        _layer_shapes(out, f"encoder.layer_{i}", cfg, ("self_attn",),
                      ("ln1", "ln2"))
    for i in range(cfg.num_layers):
        _layer_shapes(out, f"decoder.layer_{i}", cfg,
                      ("self_attn", "cross_attn"), ("ln1", "ln2", "ln3"))
    return out


def _from_jax(named: dict, shapes: dict, scope: str, compute_dtype) -> dict:
    state = {}
    for name, shape in shapes.items():
        jax_name = f"{scope}/" + name.replace(".", "/")
        if jax_name not in named:
            raise KeyError(f"checkpoint has no variable {jax_name!r}")
        value = np.asarray(named[jax_name], np.float32)
        if value.shape != shape:
            raise ValueError(f"{jax_name}: shape {value.shape}, expected "
                             f"{shape}")
        t = torch.from_numpy(value.copy())
        if name.endswith((".kernel", ".bias")):
            t = t.to(compute_dtype)
        state[name] = t
    return state


def params_from_jax(named: dict, cfg: TransformerConfig,
                    scope: str = "causal_lm",
                    compute_dtype=torch.float32) -> dict:
    """Map JAX variable names to the port's ``state_dict`` (CPU tensors):
    Dense kernels and biases in ``compute_dtype``, the embedding and the
    LayerNorm parameters f32. Raises on a missing variable or a shape
    mismatch."""
    return _from_jax(named, _shapes(cfg), scope, compute_dtype)


def seq2seq_params_from_jax(named: dict, cfg: TransformerConfig,
                            scope: str = "transformer",
                            compute_dtype=torch.float32) -> dict:
    """:func:`params_from_jax` for the encoder-decoder: ``transformer/
    shared_embedding``, ``transformer/encoder/layer_{i}/{self_attn/{q,k,v,
    out},ffn/{in,out}}/{kernel,bias}``, ``…/ln1|ln2/{gamma,beta}``, and
    ``transformer/decoder/layer_{i}/…`` with ``cross_attn`` and ``ln3``, to
    a :class:`..models.transformer.Seq2SeqStack` ``state_dict``."""
    return _from_jax(named, _seq2seq_shapes(cfg), scope, compute_dtype)


def _one(named: dict, pattern: str) -> str:
    hits = [k for k in named if re.search(pattern, k)]
    if len(hits) != 1:
        raise KeyError(f"expected one checkpoint variable matching "
                       f"{pattern!r}, found {sorted(hits)}")
    return hits[0]


def load_training_state(trainer, named: dict, host_state=None,
                        optimizer_name: str = "Adam"):
    """Carry a JAX training checkpoint's step and Adam state onto a
    :class:`..models.causal_lm.CausalLMTrainer` (its weights come from
    :func:`params_from_jax`): ``global_step``, ``…/beta1_power``,
    ``…/beta2_power`` and ``…/fused_m_g{i}``/``fused_v_g{i}`` onto the
    optimizer's groups, in order, and ``host_state["rng_run_counter"]``
    onto ``trainer.rng_counter``. From a checkpoint without a global step
    (a serving export) only the counter is carried. Raises when the slots
    do not match the groups' sizes."""
    if host_state and "rng_run_counter" in host_state:
        trainer.rng_counter = int(host_state["rng_run_counter"])
    if not any(k.split("/")[-1] == "global_step" for k in named):
        return
    opt = trainer.optimizer
    dev = opt.beta1_power.device
    trainer.set_global_step(int(named[_one(named, r"(^|/)global_step$")]))
    name = re.escape(optimizer_name)
    for attr, which in (("beta1_power", "beta1_power"),
                        ("beta2_power", "beta2_power")):
        value = named[_one(named, rf"(^|/){name}/{which}$")]
        getattr(opt, attr).fill_(float(np.asarray(value, np.float32)))
    for gi, grp in enumerate(opt.flat_groups):
        for slot in ("m", "v"):
            value = np.asarray(
                named[_one(named, rf"(^|/){name}/fused_{slot}_g{gi}$")],
                np.float32)
            if value.shape != (len(grp),):
                raise ValueError(
                    f"flat Adam slot {slot} of group {gi}: shape "
                    f"{value.shape}, the port's group holds {len(grp)}")
            getattr(grp, slot).copy_(torch.from_numpy(value).to(dev))


def _init(shapes: dict, cfg: TransformerConfig, seed: int) -> dict:
    rng = np.random.RandomState(seed)
    state = {}
    for name, shape in shapes.items():
        if name == "shared_embedding":
            v = rng.standard_normal(shape) * cfg.d_model ** -0.5
        elif name.endswith(".kernel"):
            limit = np.sqrt(3.0 / ((shape[0] + shape[1]) / 2.0))
            v = rng.uniform(-limit, limit, shape)
        elif name.endswith(".gamma"):
            v = np.ones(shape)
        else:
            v = np.zeros(shape)
        state[name] = torch.from_numpy(v.astype(np.float32))
    return state


def init_params(cfg: TransformerConfig, seed: int = 0) -> dict:
    """Random weights from ``numpy.random.RandomState(seed)`` with the JAX
    model's initializers: embedding ~ N(0, d_model**-0.5), dense kernels
    variance-scaling (fan_avg, uniform), biases and LN beta 0, LN gamma 1.
    Returns a ``state_dict`` of CPU f32 tensors."""
    return _init(_shapes(cfg), cfg, seed)


def init_seq2seq_params(cfg: TransformerConfig, seed: int = 0) -> dict:
    """:func:`init_params` for the encoder-decoder
    (:func:`seq2seq_params_from_jax`'s names)."""
    return _init(_seq2seq_shapes(cfg), cfg, seed)


# -- ResNet ----------------------------------------------------------------------

def _resnet_shapes(num_classes: int) -> dict:
    """Port ``state_dict`` name -> shape of ResNet-50 (parameters in
    creation order, then the BatchNorm buffers), from a model on the meta
    device."""
    from .models.resnet import ResNet

    model = ResNet(50, num_classes, device="meta")
    return {name: tuple(t.shape) for name, t in model.state_dict().items()}


def _hwio_to_oihw(value: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(value.transpose(3, 2, 0, 1))


def resnet_params_from_jax(named: dict, dtype=torch.float32,
                           scope: str = "resnet") -> dict:
    """Map ResNet-50's ``resnet/...`` variables (``num_classes`` read
    from ``fc/bias``) to the port's ``state_dict`` (CPU tensors): conv
    kernels
    HWIO -> OIHW in ``dtype``, BatchNorm parameters and statistics and the
    fc f32. Raises on a missing variable or a shape mismatch."""
    num_classes = int(np.asarray(named[f"{scope}/fc/bias"]).shape[0])
    state = {}
    for name, shape in _resnet_shapes(num_classes).items():
        jax_name = f"{scope}/" + name.replace(".", "/")
        if jax_name not in named:
            raise KeyError(f"checkpoint has no variable {jax_name!r}")
        value = np.asarray(named[jax_name], np.float32)
        if value.ndim == 4:
            value = _hwio_to_oihw(value)
        if value.shape != shape:
            raise ValueError(f"{jax_name}: shape {value.shape} (port "
                             f"layout), expected {shape}")
        t = torch.from_numpy(value.copy())
        state[name] = t.to(dtype) if t.dim() == 4 else t
    return state


def resnet_slot_from_jax(group, flat: np.ndarray) -> np.ndarray:
    """A JAX flat slot of ``group``'s layout (per-parameter segments in
    the same order and sizes; conv kernels flattened HWIO) in the port's
    element order (conv kernels flattened OIHW)."""
    flat = np.asarray(flat, np.float32)
    if flat.shape != (len(group),):
        raise ValueError(f"flat slot of shape {flat.shape}, the port's "
                         f"group holds {len(group)}")
    out = flat.copy()
    for p, off, size in zip(group.params, group.offsets, group.sizes):
        if p.dim() == 4:
            o, i, kh, kw = p.shape
            seg = flat[off:off + size].reshape(kh, kw, i, o)
            out[off:off + size] = _hwio_to_oihw(seg).reshape(-1)
    return out


def load_resnet_training_state(trainer, named: dict,
                               optimizer_name: str = "Momentum"):
    """Carry a JAX ResNet training checkpoint's ``global_step`` and flat
    Momentum slots (``…/fused_momentum_g{i}``, one per ``(param dtype,
    update dtype)`` group in the same order) onto a
    :class:`..models.resnet.ResNetTrainer` (its weights come from
    :func:`resnet_params_from_jax`). From a checkpoint without a global
    step (weights only) nothing is carried."""
    if not any(k.split("/")[-1] == "global_step" for k in named):
        return
    trainer.global_step = int(named[_one(named, r"(^|/)global_step$")])
    name = re.escape(optimizer_name)
    for gi, grp in enumerate(trainer.optimizer.flat_groups):
        value = named[_one(named, rf"(^|/){name}/fused_momentum_g{gi}$")]
        grp.momentum.copy_(torch.from_numpy(
            resnet_slot_from_jax(grp, value)).to(grp.momentum.device))


def _truncated_normal(rng, shape, stddev):
    """N(0, stddev) redrawn beyond two standard deviations (TF's
    ``truncated_normal``)."""
    v = rng.standard_normal(int(np.prod(shape)))
    bad = np.abs(v) > 2.0
    while bad.any():
        v[bad] = rng.standard_normal(int(bad.sum()))
        bad = np.abs(v) > 2.0
    return (v * stddev).reshape(shape)


def init_resnet_params(seed: int = 0, num_classes: int = 1000) -> dict:
    """Random ResNet-50 weights from ``numpy.random.RandomState(seed)`` with
    the JAX model's initializers: conv kernels
    ``VarianceScaling(2.0, "fan_out", "truncated_normal")`` (stddev
    ``sqrt(2 / (kh * kw * out)) / 0.8796``), fc kernel N(0, 0.01), biases
    and BatchNorm beta and moving mean 0, gamma and moving variance 1.
    The same distributions as JAX, not its bits. Returns a ``state_dict``
    of CPU f32 tensors (conv kernels OIHW)."""
    rng = np.random.RandomState(seed)
    state = {}
    for name, shape in _resnet_shapes(num_classes).items():
        leaf = name.split(".")[-1]
        if len(shape) == 4:
            fan_out = shape[0] * shape[2] * shape[3]
            v = _truncated_normal(rng, shape,
                                  np.sqrt(2.0 / fan_out) / 0.87962566103423978)
        elif leaf == "kernel":
            v = rng.standard_normal(shape) * 0.01
        elif leaf in ("gamma", "moving_variance"):
            v = np.ones(shape)
        else:
            v = np.zeros(shape)
        state[name] = torch.from_numpy(v.astype(np.float32))
    return state


def load_session_variables(sess, named: dict) -> None:
    """Load ``named`` (``{JAX variable store name: numpy array}``, e.g. a
    JAX session's ``_variable_store.values`` or :func:`load_stfz` of its
    checkpoint) into the port Session ``sess``'s ``VariableStore``, each
    in its graph variable's dtype: the weights (bf16 Dense variables of a
    bf16 graph included: bfloat16 numpy values, or their raw 2-byte bits,
    widened exactly by :func:`bf16_to_f32`), the optimizer's flat Adam
    slots and beta powers, and the global step. A name no Variable of
    ``sess.graph`` has raises ``KeyError``."""
    from .ops import variables as variables_mod

    registry = variables_mod.variables_by_store_name(sess.graph)
    missing = sorted(set(named) - set(registry))
    if missing:
        raise KeyError(f"no variable named {missing[:5]} in the session's "
                       "graph")
    for name, value in named.items():
        value = np.asarray(value)
        if value.dtype.kind == "V" and value.dtype.itemsize == 2 and \
                value.dtype.name != "bfloat16":
            value = bf16_to_f32(value)
        sess._variable_store.load(name, value, registry[name])
