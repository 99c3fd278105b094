"""Kernel routing mode of the port (``stf.kernels``): the mode half of
``simple_tensorflow_tpu/kernels/registry.py`` (``MODES``, ``set_mode``
:90, ``current_mode`` :105). The port reads no environment variable for
it: the default is ``"auto"`` until ``set_mode`` changes it. A Session
has no mode of its own here.

In the port the mode decides one thing, when a graph is built: under
``"off"`` a graph optimizer whose update is fused
(``train.MomentumOptimizer``) builds its per-variable update ops instead
of the one fused op, as the JAX kill switch does. ``"force"`` is
accepted so that JAX user code calling ``set_mode("force")`` runs, and
does the same as ``"auto"``. The mode never routes a kernel: a wrapper
launches its kernel for a CUDA tensor and takes the plain version for a
CPU tensor whatever the mode.
"""

from __future__ import annotations

from typing import Optional

MODES = ("off", "auto", "force")

_DEFAULT = "auto"
_mode = _DEFAULT


def set_mode(mode: Optional[str]) -> None:
    """Set the process mode (None: back to ``"auto"``). Graphs built
    afterwards follow it."""
    global _mode
    if mode is not None and mode not in MODES:
        raise ValueError(f"kernel registry mode must be one of {MODES}, "
                         f"got {mode!r}")
    _mode = _DEFAULT if mode is None else mode


def current_mode() -> str:
    """The mode graphs built now follow."""
    return _mode
