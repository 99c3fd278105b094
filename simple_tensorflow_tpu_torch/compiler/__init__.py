"""Compiled steps of the port: a planned Session step, or a serving
bucket's program, captured once as a CUDA graph and replayed
(``compiler/aot.py``)."""

from .aot import (DeviceGraph, StagedInput, StepExecutable, compile_step,
                  feed_signature, on_side_stream)

__all__ = ["DeviceGraph", "StagedInput", "StepExecutable", "compile_step",
           "feed_signature", "on_side_stream"]
