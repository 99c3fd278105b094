"""stf.checkpoint of the port: the atomic commit protocol (``atomic``),
the stf-bundle format's native path (``snapshot``) and preemption-safe
training (``preemption``). The async plane (``CheckpointManager``,
``AsyncSaverEngine``, the writer thread) waits for ROADMAP Queue 1
item 10."""

from .atomic import (COMMIT_POINTS, atomic_write_bytes, atomic_write_json,
                     checksum_bytes, checksum_file, set_fault_hook)
from .preemption import (PreemptionHandler, install_preemption_handler,
                         preemption_requested, request_preemption,
                         reset_preemption_state,
                         uninstall_preemption_handler)
from .snapshot import (read_index, verify_checkpoint,
                       write_native_checkpoint)
