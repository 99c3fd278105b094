"""stf.checkpoint of the port: the atomic commit protocol (``atomic``),
the stf-bundle format's native path and the barrier snapshots
(``snapshot``), the async plane (``writer``: the ``stf_ckpt_writer``
thread; ``manager``: ``AsyncSaverEngine`` and ``CheckpointManager``),
preemption-safe training (``preemption``) and the ``/stf/checkpoint/*``
metrics (``metrics``). Sharded and orbax checkpoints wait for ROADMAP
Queue 1 item 11."""

from . import metrics  # registers the /stf/checkpoint/* families
from .atomic import (COMMIT_POINTS, atomic_write_bytes, atomic_write_json,
                     checksum_bytes, checksum_file, set_fault_hook)
from .preemption import (PreemptionHandler, install_preemption_handler,
                         preemption_requested, request_preemption,
                         reset_preemption_state,
                         uninstall_preemption_handler)
from .snapshot import (TrainingStateSnapshot, capture_training_state,
                       read_index, verify_checkpoint,
                       write_native_checkpoint)
from .writer import (CheckpointWriter, PendingCheckpoint, get_writer,
                     shutdown_writer, wait_until_finished)
from .manager import AsyncSaverEngine, CheckpointManager
