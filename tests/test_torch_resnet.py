"""The PyTorch port's ResNet-50 Momentum training slice against the JAX
package's.

The same numpy-seeded inputs go through the port and through the JAX
function as the JAX package's own tests run it on the CPU (the Pallas
Momentum kernel in interpret mode). Stated tolerances:

- K5 Momentum: the port's plain version bit-exact with the JAX composed
  reference (every operation rounded on both sides) and within 8 ulp of
  the larger summand of the JAX Pallas kernel, whose multiply-adds the
  compiler may contract; always from non-zero accumulators, since a
  first step from zero never reads ``mu``;
- layers, f32: conv2d and the BatchNorm forward rtol/atol 1e-5 (sums in
  another order), the BatchNorm VJP 1e-4 (reductions over the batch);
  max pooling exact (a max of the same values); bf16: 2e-2 (a bf16
  rounding, which XLA may place elsewhere);
- the slice as a whole, f32 (batch 4 x 64^2, 10 classes, lr 1e-2), from
  the JAX session's ``.stfz`` checkpoints. Its f32 gradients are only
  good to a few per cent: the BatchNorm backward cancels most of every
  upstream gradient, so the JAX and the port's f32 gradients each differ
  from a float64 evaluation by 2-4% in the early layers (measured), and
  this recipe overshoots on its one repeated batch: a free run amplifies
  that difference from step to step (JAX's own third loss is 4.0840 or
  3.8835 on one AVX-512 box, by the oneDNN code path, ONEDNN_MAX_CPU_ISA
  unset or AVX2; ``tests/host_spread.py`` records it). So the run is
  teacher-forced: each of steps 1-3 through ``trainer.step`` starts from
  the JAX session's state before it (the initial checkpoint, then its
  parameters and Momentum slot after steps 1 and 2) and gives JAX's loss
  within rtol 1e-5 (a forward of the same weights), and the update it
  makes matches JAX's by relative norm, each parameter within 0.1 and the
  fc's within 1e-3: the gradients behind it were measured at worst 5.9%
  and 1.3e-4 (4.9% on the AVX2 path), where the two paths move JAX's own
  step-1 gradients by up to 3.2% (``tests/host_spread.py``).
  The exact chain runs from the after-step-1 checkpoint,
  whose global step and non-zero Momentum slot the port carries. At each
  of steps 2 and 3: the loss of the carried state rtol 1e-5; the
  gradient the JAX step used, read back from its slots (``g = acc_new -
  mu * acc``), against the port's by relative norm 0.1 (measured worst
  4.2%; the fc's 1e-3); and that gradient through the port's optimizer
  gives the JAX session's slot within 2 ulp of ``|mu * acc| + |g|`` and
  its parameters within 4 ulp of ``|p| + lr * (|mu * acc| + |g|)``
  (step 3 starts again from the JAX session's state, so no roundoff
  carries over). So the parameters and slots after step 3 are the JAX
  session's. Per-parameter flat offsets exact.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import simple_tensorflow_tpu as stf
from simple_tensorflow_tpu.models import resnet as jres
from simple_tensorflow_tpu.ops import nn_impl as jnn_impl
from simple_tensorflow_tpu.ops import nn_ops as jnn_ops
from simple_tensorflow_tpu_torch import convert
from simple_tensorflow_tpu_torch.models import resnet as pres
from simple_tensorflow_tpu_torch.ops import kernels as K
from simple_tensorflow_tpu_torch.ops import nn_impl, nn_ops
from simple_tensorflow_tpu_torch.train import optimizers as popt
from torch_threads import one_thread

jfu = importlib.import_module("simple_tensorflow_tpu.ops.pallas."
                              "fused_update")

FWD = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=2e-2, atol=2e-2)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True, order="C"))


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _jdt(dtype):
    return jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32


def _within_ulp(got, want, scale, max_ulp):
    bound = max_ulp * np.spacing(np.abs(scale).astype(np.float32))
    return bool(np.all(np.abs(got - want) <= bound))


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ---------------------------------------------------------------------------
# K5 Momentum
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nesterov", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_momentum_update_matches_jax(dtype, nesterov):
    rng = np.random.RandomState(41)
    n = 1000                            # not a multiple of 128 lanes
    p = rng.randn(n).astype(np.float32)
    acc = (rng.randn(n) * 0.5).astype(np.float32)     # non-zero: mu is read
    g = (rng.randn(n) * 0.1).astype(np.float32)
    g[:4] = [0.0, 1e-30, -3.0, 7.5]
    tp, tg = _t(p).to(dtype), _t(g).to(dtype)
    pw, gw = tp.float().numpy(), tg.float().numpy()
    jp = jnp.asarray(pw, _jdt(dtype))
    lr, mu = np.float32(0.1), np.float32(0.9)
    for fn in (K.momentum_update, K.momentum_update_plain):
        got = fn(tp.clone(), _t(acc.copy()), tg, torch.tensor(lr),
                 torch.tensor(mu), use_nesterov=nesterov)
        got = [t.float().numpy() for t in got]
        ref = jfu.momentum_update_reference(
            jp, jnp.asarray(acc), jnp.asarray(gw), jnp.asarray(lr),
            jnp.asarray(mu), use_nesterov=nesterov)
        pallas = jfu.momentum_update(
            jp, jnp.asarray(acc), jnp.asarray(gw), jnp.asarray(lr),
            jnp.asarray(mu), use_nesterov=nesterov)
        # the larger summand of each result: p and the step it took;
        # mu * acc and g
        scales = (np.abs(pw) + np.abs(pw - got[0]),
                  np.abs(0.9 * acc) + np.abs(gw))
        for a, r, k, scale in zip(got, ref, pallas, scales):
            np.testing.assert_array_equal(a, _np(r))
            assert _within_ulp(a, _np(k), scale, 8)
    # the check can see mu: a one-ulp-larger mu moves the accumulator
    off = fn(tp.clone(), _t(acc.copy()), tg, torch.tensor(lr),
             torch.tensor(np.nextafter(mu, np.float32(1))),
             use_nesterov=nesterov)[1]
    assert not np.array_equal(off.numpy(), got[1])


def test_momentum_optimizer_names_its_slot_and_itself():
    a = torch.nn.Parameter(torch.ones(3))
    w = torch.nn.Parameter(torch.ones(2, 2, dtype=torch.bfloat16))
    opt = popt.FlatMomentum([a, w], learning_rate=0.5, momentum=0.9)
    assert [len(grp) for grp in opt.flat_groups] == [3, 4]
    assert [list(grp.slots) for grp in opt.flat_groups] == [["momentum"]] * 2
    assert opt.update is K.momentum_update
    (a.sum() + w.float().sum()).backward()
    opt.step()
    opt.step()                # acc = 0.9 * 1 + 1; p = 1 - 0.5 - 0.95
    torch.testing.assert_close(a.detach(), torch.full((3,), -0.45))
    torch.testing.assert_close(opt.flat_groups[0].momentum,
                               torch.full((3,), 1.9))
    a.grad = None
    with pytest.raises(RuntimeError, match="FlatMomentum: parameter 0"):
        opt.step()


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,stride,size", [(1, 1, 9), (1, 2, 9), (1, 2, 8),
                                           (3, 1, 8), (3, 2, 8), (3, 2, 7),
                                           (7, 2, 16), (7, 2, 15)])
def test_conv2d_same_padding_matches_jax(k, stride, size):
    rng = np.random.RandomState(k * 100 + stride * 10 + size)
    x = rng.randn(2, size, size, 5).astype(np.float32)
    w = (rng.randn(k, k, 5, 6) / np.sqrt(k * k * 5)).astype(np.float32)
    strides = [1, stride, stride, 1]
    want = _np(jnn_ops._conv2d_impl(jnp.asarray(x), jnp.asarray(w),
                                    strides=strides, padding="SAME"))
    got = nn_ops._conv2d_impl(_t(x), _t(w), strides, "SAME")
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **FWD)
    # through the layer: a contiguous OIHW kernel viewed as HWIO
    from simple_tensorflow_tpu_torch.layers.convolutional import \
        Conv2DModule

    layer = Conv2DModule(5, 6, k, stride, padding="same")
    bias = rng.randn(6).astype(np.float32)
    with torch.no_grad():
        layer.kernel.copy_(_t(w.transpose(3, 2, 0, 1)))
        layer.bias.copy_(_t(bias))
    assert layer.kernel.is_contiguous()
    np.testing.assert_allclose(layer(_t(x)).detach().numpy(), want + bias,
                               **FWD)


def test_same_padding_puts_the_odd_element_after():
    assert nn_ops.same_padding(224, 7, 2) == (2, 3)
    assert nn_ops.same_padding(56, 3, 2) == (0, 1)
    assert nn_ops.same_padding(112, 3, 2) == (0, 1)
    assert nn_ops.same_padding(56, 1, 2) == (0, 0)
    assert nn_ops.same_padding(7, 3, 2) == (1, 1)


@pytest.mark.parametrize("size", [8, 9, 14])
def test_max_pool_same_and_vjp_match_jax(size):
    rng = np.random.RandomState(size)
    x = rng.randn(2, size, size, 4).astype(np.float32)
    dy_shape = (2, -(-size // 2), -(-size // 2), 4)
    dy = rng.randn(*dy_shape).astype(np.float32)
    kw = dict(ksize=(1, 3, 3, 1), strides=(1, 2, 2, 1), padding="SAME")
    want, vjp = jax.vjp(lambda a: jnn_ops._max_pool_impl(a, **kw),
                        jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(dy))
    xt = _t(x).requires_grad_()
    got = nn_ops._max_pool_impl(xt, [1, 3, 3, 1], [1, 2, 2, 1], "SAME")
    got.backward(_t(dy))
    np.testing.assert_array_equal(got.detach().numpy(), _np(want))
    np.testing.assert_array_equal(xt.grad.numpy(), _np(want_dx))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_batch_norm_and_vjp_match_jax(dtype):
    rng = np.random.RandomState(7)
    x = (rng.randn(3, 5, 4, 6) * 2.0 + 0.7).astype(np.float32)
    scale = (1.0 + 0.1 * rng.randn(6)).astype(np.float32)
    offset = (0.1 * rng.randn(6)).astype(np.float32)
    dy = rng.randn(3, 5, 4, 6).astype(np.float32)
    dmean = rng.randn(6).astype(np.float32)
    dvar = rng.randn(6).astype(np.float32)
    xt = _t(x).to(dtype)
    xj = jnp.asarray(xt.float().numpy(), _jdt(dtype))
    dyt = _t(dy).to(dtype)
    dyj = jnp.asarray(dyt.float().numpy(), _jdt(dtype))
    outs, vjp = jax.vjp(lambda a, s, o: jnn_impl._bn_train(
        a, s, o, 1e-5, (0, 1, 2)), xj, jnp.asarray(scale),
        jnp.asarray(offset))
    grads = vjp((dyj, jnp.asarray(dmean), jnp.asarray(dvar)))
    xg = xt.clone().requires_grad_()
    sg = _t(scale).requires_grad_()
    og = _t(offset).requires_grad_()
    y, mean, var = nn_impl.FusedBatchNormFunction.apply(xg, sg, og, 1e-5)
    assert y.dtype == dtype and mean.dtype == var.dtype == torch.float32
    torch.autograd.backward((y, mean, var), (dyt, _t(dmean), _t(dvar)))
    fwd, grad = (FWD, GRAD) if dtype == torch.float32 else (BF16, BF16)
    for got, want, tol in ((y, outs[0], fwd), (mean, outs[1], FWD),
                           (var, outs[2], FWD), (xg.grad, grads[0], grad),
                           (sg.grad, grads[1], GRAD),
                           (og.grad, grads[2], GRAD)):
        np.testing.assert_allclose(got.detach().float().numpy(), _np(want),
                                   **tol)
    # inference: the given statistics
    mm = (0.1 * rng.randn(6)).astype(np.float32)
    mv = (1.0 + rng.rand(6)).astype(np.float32)
    want = jnn_impl._fused_bn_impl(xj, jnp.asarray(scale),
                                   jnp.asarray(offset), jnp.asarray(mm),
                                   jnp.asarray(mv), epsilon=1e-5,
                                   is_training=False)[0]
    got = nn_impl.fused_batch_norm(xt, _t(scale), _t(offset), _t(mm),
                                   _t(mv), epsilon=1e-5,
                                   is_training=False)[0]
    np.testing.assert_allclose(got.float().numpy(), _np(want), **fwd)


def test_one_pass_variance_for_half_precision_only():
    # a large mean over a small spread: the two-pass f32 variance keeps
    # it, the one-pass bf16 form clips at 0 or keeps what rounding leaves
    x = torch.full((64, 1), 300.0) + torch.linspace(-0.01, 0.01, 64)[:, None]
    ones, zeros = torch.ones(1), torch.zeros(1)
    _, _, var32 = nn_impl.FusedBatchNormFunction.apply(x, ones, zeros, 1e-5)
    torch.testing.assert_close(var32, x.var(0, unbiased=False), rtol=1e-3,
                               atol=0.0)
    xb = x.to(torch.bfloat16)
    _, mean_b, var_b = nn_impl.FusedBatchNormFunction.apply(xb, ones, zeros,
                                                            1e-5)
    xf = xb.float()
    want = torch.clamp_min((xf * xf).mean(0) - mean_b * mean_b, 0.0)
    assert torch.equal(var_b, want) and var_b.item() >= 0.0


# ---------------------------------------------------------------------------
# The slice as a whole
# ---------------------------------------------------------------------------

B, SIZE, CLASSES, LR = 4, 64, 10, 1e-2
# f32 bounds (module docstring): gradients and a step's update by relative
# norm per parameter, all and the fc's
GRAD_COND, GRAD_FC = 1e-1, 1e-3


def _batch():
    images, labels = jres.synthetic_imagenet(B, SIZE)
    return images, labels % CLASSES


def _jax_layout(graph):
    """The parameter names of each flat group of the graph's fused
    Momentum update, in flat order."""
    ops = [op for op in graph.get_operations()
           if op.type == "FusedMomentumUpdate"]
    assert len(ops) == 1
    return [list(group) for group in ops[0].attrs["group_params"]]


def _slot_name(values):
    (name,) = [k for k in values if k.endswith("fused_momentum_g0")]
    return name


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """Init, save, step 1, save, steps 2-3 of the JAX training graph: the
    losses, every variable after steps 2 and 3, and the flat layout
    (parameter names per group)."""
    ckpt = tmp_path_factory.mktemp("resnet_f32")
    images, labels = _batch()
    g = stf.Graph()
    with g.as_default():
        stf.set_random_seed(5)
        m = jres.resnet50_train_model(batch_size=B, image_size=SIZE,
                                      num_classes=CLASSES, dtype=stf.float32,
                                      learning_rate=LR)
        layout = _jax_layout(g)
        saver = stf.train.Saver()
        variables = stf.global_variables()
        names = [v.name.split(":")[0] for v in variables]
        feed = {m["images"]: images, m["labels"]: labels}
        with stf.Session(graph=g) as sess:
            sess.run(stf.global_variables_initializer())
            ck0 = saver.save(sess, str(ckpt / "init"))
            losses, values = [], {}
            for i in range(3):
                loss, acc, _ = sess.run([m["loss"], m["accuracy"],
                                         m["train_op"]], feed)
                losses.append(float(loss))
                if i == 0:
                    acc0 = float(acc)
                    ck1 = saver.save(sess, str(ckpt / "step1"))
                else:
                    values[i + 1] = dict(zip(names, map(
                        np.asarray, sess.run(variables))))
    values[1] = convert.load_stfz(ck1)
    sizes = {name: values[3][name].size for group in layout for name in group}
    return dict(losses=losses, acc0=acc0, values=values, layout=layout,
                sizes=sizes, ck0=ck0, ck1=ck1)


def _port(ckpt, dtype=torch.float32):
    # built in one thread (torch_threads); its steps run at the default
    # count, whose sums the free-run bound above was measured with
    with one_thread():
        return pres.resnet50_trainer(batch_size=B, image_size=SIZE,
                                     num_classes=CLASSES, dtype=dtype,
                                     learning_rate=LR, checkpoint=ckpt,
                                     device="cpu")


def _port_name(jax_name):
    return jax_name[len("resnet/"):].replace("/", ".")


def _as_jax_layout(value):
    """A port parameter (conv kernels OIHW) in the JAX layout (HWIO)."""
    return value.transpose(2, 3, 1, 0) if value.ndim == 4 else value


def _state(trainer):
    """``{JAX name: (parameter, its slot)}`` of the port, in the JAX
    layout: copies, which a later step leaves as they were."""
    (grp,) = trainer.optimizer.flat_groups
    acc = grp.momentum.numpy().copy()
    out = {}
    for (name, p), off, size in zip(
            trainer.model.named_parameters(), grp.offsets, grp.sizes):
        out["resnet/" + name.replace(".", "/")] = (
            _as_jax_layout(p.detach().float().numpy().copy()),
            _as_jax_layout(acc[off:off + size].reshape(p.shape)).reshape(-1))
    return out


def _slot_segments(values, layout, sizes):
    slot = values[_slot_name(values)]
    offs = np.cumsum([0] + [sizes[n] for n in layout[0]])
    return {n: slot[a:b] for n, a, b in zip(layout[0], offs, offs[1:])}


def test_resnet_trains_like_jax_from_one_checkpoint(jax_run):
    # teacher-forced (module docstring): each of the three steps through
    # trainer.step starts from the JAX session's state before it
    trainer = _port(jax_run["ck0"])
    images, labels = _batch()
    assert trainer.accuracy(images, labels).item() == jax_run["acc0"]
    values = jax_run["values"]
    for k in range(3):
        if k:
            _load_state(trainer, values[k])
        before = _state(trainer)
        loss = trainer.step(images, labels).item()
        # a forward of the JAX session's weights
        np.testing.assert_allclose(loss, jax_run["losses"][k], rtol=1e-5)
        assert trainer.global_step == k + 1
        # the update the step made against the JAX step's, each parameter
        # by relative norm (f64 differences of f32 values: exact)
        errs = {}
        for name, (p, _) in _state(trainer).items():
            p0 = before[name][0].astype(np.float64)
            errs[name] = _rel(p.astype(np.float64) - p0,
                              values[k + 1][name].astype(np.float64) - p0)
        assert max(errs.values()) <= GRAD_COND, errs
        assert max(errs["resnet/fc/kernel"], errs["resnet/fc/bias"]) <= \
            GRAD_FC, errs
    # BatchNorm's moving statistics: never updated, on either side
    values = jax_run["values"][3]
    for name, buf in trainer.model.named_buffers():
        init = np.ones if name.endswith("variance") else np.zeros
        want_buf = values["resnet/" + name.replace(".", "/")]
        np.testing.assert_array_equal(want_buf, init(want_buf.shape))
        np.testing.assert_array_equal(buf.numpy(), init(want_buf.shape))


def _apply_gradient(trainer, grads):
    """One optimizer step of the port from JAX-layout gradients."""
    opt = trainer.optimizer
    opt.zero_grad()
    with torch.no_grad():
        for (name, p) in trainer.model.named_parameters():
            grad = grads["resnet/" + name.replace(".", "/")]
            p.grad.copy_(_t(grad.transpose(3, 2, 0, 1) if grad.ndim == 4
                            else grad))
    opt.step()


def _load_state(trainer, values):
    """The JAX session's parameters and slot (JAX layout) into the port's
    flat buffers."""
    (grp,) = trainer.optimizer.flat_groups
    with torch.no_grad():
        for name, p in trainer.model.named_parameters():
            v = values["resnet/" + name.replace(".", "/")]
            p.copy_(_t(v.transpose(3, 2, 0, 1) if v.ndim == 4 else v))
        grp.momentum.copy_(_t(convert.resnet_slot_from_jax(
            grp, values[_slot_name(values)])))


def test_resnet_resumes_from_a_jax_training_checkpoint(jax_run):
    trainer = _port(jax_run["ck1"])
    assert trainer.global_step == 1
    layout, sizes, values = jax_run["layout"], jax_run["sizes"], \
        jax_run["values"]
    mu, lr = np.float32(0.9), np.float32(LR)
    images, labels = _batch()
    for k in (1, 2):
        slots = _slot_segments(values[k], layout, sizes)
        if k > 1:
            _load_state(trainer, values[k])
        before = _state(trainer)
        for name, (p, acc) in before.items():       # the carried state
            assert np.any(acc) and np.array_equal(acc, slots[name]), name
            assert np.array_equal(p, values[k][name]), name
        loss = trainer.loss_and_grads(images, labels).item()
        np.testing.assert_allclose(loss, jax_run["losses"][k], rtol=1e-5)
        # the gradient the JAX step used, from its Momentum slots
        new_slots = _slot_segments(values[k + 1], layout, sizes)
        used = {name: (new_slots[name] - mu * slots[name]).reshape(
            values[k][name].shape) for name in slots}
        errs = {name: _rel(_as_jax_layout(p.grad.numpy()),
                           used["resnet/" + name.replace(".", "/")])
                for name, p in trainer.model.named_parameters()}
        assert max(errs.values()) <= GRAD_COND, errs
        assert max(errs["fc.kernel"], errs["fc.bias"]) <= GRAD_FC, errs
        _apply_gradient(trainer, used)
        for name, (p, acc) in _state(trainer).items():
            p0, acc0 = before[name]
            # ulps of the larger summands: mu * acc and g; p and lr * acc
            acc_scale = np.abs(mu * acc0) + np.abs(used[name].reshape(-1))
            assert _within_ulp(acc, new_slots[name], acc_scale, 2), name
            assert _within_ulp(p, values[k + 1][name], np.abs(p0) + lr *
                               acc_scale.reshape(p0.shape), 4), name


def test_flat_layout_matches_the_jax_slots(jax_run):
    trainer = _port(jax_run["ck0"])
    names = [n for n, _ in trainer.model.named_parameters()]
    (grp,) = trainer.optimizer.flat_groups
    (jax_group,) = jax_run["layout"]
    assert [_port_name(n) for n in jax_group] == names
    sizes = [jax_run["sizes"][n] for n in jax_group]
    assert list(np.cumsum([0] + sizes[:-1])) == grp.offsets
    values = jax_run["values"][3]
    assert len(grp) == values[_slot_name(values)].size


def test_bf16_graph_has_the_two_group_layout():
    g = stf.Graph()
    with g.as_default():
        jres.resnet50_train_model(batch_size=B, image_size=SIZE,
                                  num_classes=CLASSES)
        layout = _jax_layout(g)
        sizes = {v.name.split(":")[0]: int(np.prod(v.shape.as_list()))
                 for v in stf.trainable_variables()}
    with one_thread():
        trainer = pres.resnet50_trainer(batch_size=B, image_size=SIZE,
                                        num_classes=CLASSES, device="cpu")
    names = {id(p): n for n, p in trainer.model.named_parameters()}
    groups = trainer.optimizer.flat_groups
    assert [(grp.p.dtype, grp.momentum.dtype) for grp in groups] == [
        (torch.bfloat16, torch.float32), (torch.float32, torch.float32)]
    for grp, jax_group in zip(groups, layout):
        assert [names[id(p)] for p in grp.params] == \
            [_port_name(n) for n in jax_group]
        assert len(grp) == sum(sizes[n] for n in jax_group)
    assert len(groups[0]) == 23454912      # ResNet-50's conv kernels
    assert all(names[id(p)].endswith("kernel") and p.dim() == 4
               for p in groups[0].params)


def test_unported_options_raise():
    for flag in ("data_parallel", "recompute", "conv0_space_to_depth"):
        with pytest.raises(NotImplementedError, match="later slice"):
            pres.resnet50_trainer(batch_size=2, image_size=32,
                                  num_classes=10, device="cpu",
                                  **{flag: True})


def test_init_resnet_params_draws_the_jax_initializers():
    with one_thread():
        state = convert.init_resnet_params(seed=3)
        again = convert.init_resnet_params(seed=3)
    k = state["stage2_block0.conv2.kernel"].numpy()      # (256, 256, 3, 3)
    std = np.sqrt(2.0 / (3 * 3 * 256)) / 0.87962566103423978
    assert k.shape == (256, 256, 3, 3)
    assert np.abs(k).max() <= 2 * std
    assert abs(k.std() / (std * 0.87962566103423978) - 1) < 0.02
    fc = state["fc.kernel"].numpy()
    assert fc.shape == (2048, 1000) and abs(fc.std() / 0.01 - 1) < 0.02
    assert not state["fc.bias"].any()
    assert state["bn0.gamma"].eq(1).all() and state["bn0.beta"].eq(0).all()
    assert state["bn0.moving_variance"].eq(1).all()
    for a, b in zip(state.values(), again.values()):
        assert torch.equal(a, b)
