"""/stf/checkpoint/* metric families; a copy of ``simple_tensorflow_tpu/
checkpoint/metrics.py`` under the same names, so a counter reads the same
in both packages. One module, so importing ``stf.checkpoint`` registers
the whole family."""

from __future__ import annotations

from ..platform import monitoring

saves = monitoring.Counter(
    "/stf/checkpoint/saves",
    "Completed checkpoint saves, by mode (async = barrier snapshot + "
    "background write, blocking = in-line Saver.save)", "mode")
save_stall_seconds = monitoring.Sampler(
    "/stf/checkpoint/save_stall_seconds",
    monitoring.ExponentialBuckets(1e-5, 2.0, 24),
    "Seconds the step loop was blocked per save (async: device-copy "
    "snapshot + enqueue; blocking: full serialize + fsync)", "mode")
write_seconds = monitoring.Sampler(
    "/stf/checkpoint/write_seconds",
    monitoring.ExponentialBuckets(1e-4, 2.0, 24),
    "Background serialize+commit seconds per checkpoint on the "
    "stf_ckpt_writer thread")
bytes_written = monitoring.Counter(
    "/stf/checkpoint/bytes_written",
    "Checkpoint payload bytes committed (tensor data + index)")
pending_writes = monitoring.IntGauge(
    "/stf/checkpoint/pending_writes",
    "Queued + in-flight async checkpoint writes")
write_errors = monitoring.Counter(
    "/stf/checkpoint/write_errors",
    "Background checkpoint writes that failed (the error re-raises on "
    "the next save()/wait_until_finished())")
restores = monitoring.Counter(
    "/stf/checkpoint/restores",
    "Checkpoint restore attempts, by outcome", "outcome")
restore_seconds = monitoring.Sampler(
    "/stf/checkpoint/restore_seconds",
    monitoring.ExponentialBuckets(1e-4, 2.0, 24),
    "Seconds per restore (verify + tensor load + host-state rebuild)")
integrity_failures = monitoring.Counter(
    "/stf/checkpoint/integrity_failures",
    "Checkpoint verification failures, by kind", "kind")
gc_deleted = monitoring.Counter(
    "/stf/checkpoint/gc_deleted",
    "Old checkpoints deleted by retention (max_to_keep / "
    "keep_checkpoint_every_n_hours)")
preemptions = monitoring.Counter(
    "/stf/checkpoint/preemptions",
    "Preemption signals observed (SIGTERM -> drain window -> save -> "
    "clean stop)")
