"""How far the CPU parity tests' numbers move with the host's code path.

XLA CPU and PyTorch both call oneDNN, whose kernels differ by instruction
set (``ONEDNN_MAX_CPU_ISA``). This script records, on the CPU, what the
limits of three port parity tests rest on:

- the Defun / recompute graph of ``tests/test_torch_function.py``: its
  values and gradients in the JAX package and in the port, and their
  distance from a float64 evaluation;
- ResNet-50's f32 graph of ``tests/test_torch_resnet.py`` (batch 4 x
  64^2): the JAX session's three losses, and the gradient each JAX step
  used (read back from its Momentum slot) beside the port's, each step
  teacher-forced from the JAX session's state;
- how often PyTorch's f32 ``torch.sqrt`` and ``torch.rsqrt`` round
  differently from the correctly rounded result (the plain Adam's root).

Run it once a code path, then compare::

    JAX_PLATFORMS=cpu python3 tests/host_spread.py record a.npz
    JAX_PLATFORMS=cpu ONEDNN_MAX_CPU_ISA=AVX2 python3 tests/host_spread.py record b.npz
    python3 tests/host_spread.py compare a.npz b.npz

``compare`` prints, for each quantity, the port against JAX in each file
and JAX against JAX across the two files (the reference's own spread).
"""

import pathlib
import sys
import tempfile

import numpy as np

TESTS = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(TESTS.parent))
sys.path.insert(0, str(TESTS))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _defun(out):
    import test_torch_function as tf

    for name, stf in tf.PKGS.items():
        run, _ = tf._run(stf)
        out[f"defun/{name}/rc"] = np.asarray(run["rc"])
        for i, g in enumerate(run["grads"]["rc"]):
            out[f"defun/{name}/grad{i}"] = np.asarray(g)
    v = tf._values()
    x, w = v["x"].astype(np.float64), v["w"].astype(np.float64)
    y = np.tanh(x @ w)
    rc = y * y + x
    dz = 2 * rc * 2 * y * (1 - y * y)
    out["defun/f64/rc"] = rc
    out["defun/f64/grad0"] = dz @ w.T + 2 * rc
    out["defun/f64/grad1"] = x.T @ dz


def _resnet(out):
    import test_torch_resnet as tr

    class Dirs:
        def mktemp(self, name):
            return pathlib.Path(tempfile.mkdtemp(prefix=name))

    run = tr.jax_run.__wrapped__(Dirs())
    out["resnet/jax/losses"] = np.asarray(run["losses"])
    trainer = tr._port(run["ck0"])
    images, labels = tr._batch()
    mu = np.float32(0.9)
    values, layout, sizes = run["values"], run["layout"], run["sizes"]
    losses = []
    for k in range(3):
        if k:
            tr._load_state(trainer, values[k])
        before = tr._state(trainer)
        losses.append(trainer.step(images, labels).item())
        slots = tr._slot_segments(values[k + 1], layout, sizes)
        for name, (_, acc) in tr._state(trainer).items():
            acc0 = before[name][1]
            g_jax = slots[name] - mu * acc0
            out[f"resnet/err{k}/{name}"] = np.asarray(
                _rel(acc - mu * acc0, g_jax))
            if k == 0:   # kept whole: compared across the two files
                out[f"resnet/jax/g0/{name}"] = g_jax
    out["resnet/port/losses"] = np.asarray(losses)


def _roots(out):
    import torch

    x = np.random.RandomState(0).rand(100000).astype(np.float32) * 10
    exact = np.sqrt(x.astype(np.float64))
    for name, fn, want in (("sqrt", torch.sqrt, exact),
                           ("rsqrt", torch.rsqrt, 1 / exact)):
        got = fn(torch.from_numpy(x)).numpy()
        out[f"roots/{name}"] = np.asarray(
            np.mean(got != want.astype(np.float32)))


def record(path):
    out = {}
    _defun(out)
    _resnet(out)
    _roots(out)
    np.savez(path, **out)


def _is_batch_norm(name):
    return "/bn" in name or "_bn/" in name


def compare(path_a, path_b):
    files = {"a": np.load(path_a), "b": np.load(path_b)}
    for tag, f in files.items():
        print(f"[{tag}] torch f32 sqrt / rsqrt not correctly rounded on "
              f"{float(f['roots/sqrt']):.1%} / {float(f['roots/rsqrt']):.1%}"
              " of inputs")
        for q in ("rc", "grad0", "grad1"):
            j, p, e = (f[f"defun/{s}/{q}"] for s in ("jax", "port", "f64"))
            print(f"[{tag}] defun {q}: port - jax {np.abs(p - j).max():.3g}, "
                  f"jax - f64 {np.abs(j - e).max():.3g}, port - f64 "
                  f"{np.abs(p - e).max():.3g}, max |jax| {np.abs(j).max():.3g}")
        print(f"[{tag}] resnet losses: jax {f['resnet/jax/losses']}, port "
              f"(teacher-forced) {f['resnet/port/losses']}")
        for k in range(3):
            errs = {n.split("/", 2)[2]: float(f[n]) for n in f.files
                    if n.startswith(f"resnet/err{k}/")}
            rest = {n: e for n, e in errs.items() if not _is_batch_norm(n)}
            print(f"[{tag}] resnet step {k + 1} gradient, port vs jax: worst "
                  f"{max(errs.values()):.4f}, outside BatchNorm "
                  f"{max(rest.values()):.4f}, fc kernel "
                  f"{errs['resnet/fc/kernel']:.3g}")
    a, b = files["a"], files["b"]
    for q in ("rc", "grad0", "grad1"):
        print(f"defun {q}: jax a - jax b "
              f"{np.abs(a[f'defun/jax/{q}'] - b[f'defun/jax/{q}']).max():.3g}")
    names = [n.split("/", 3)[3] for n in a.files
             if n.startswith("resnet/jax/g0/")]
    errs = {n: _rel(b[f"resnet/jax/g0/{n}"], a[f"resnet/jax/g0/{n}"])
            for n in names}
    rest = {n: e for n, e in errs.items() if not _is_batch_norm(n)}
    print(f"resnet step 1 gradient, jax a vs jax b (the same state): worst "
          f"{max(errs.values()):.4f}, outside BatchNorm "
          f"{max(rest.values()):.4f}, fc kernel "
          f"{errs['resnet/fc/kernel']:.3g}")


if __name__ == "__main__":
    if sys.argv[1:2] == ["record"] and len(sys.argv) == 3:
        record(sys.argv[2])
    elif sys.argv[1:2] == ["compare"] and len(sys.argv) == 4:
        compare(sys.argv[2], sys.argv[3])
    else:
        sys.exit(__doc__)
