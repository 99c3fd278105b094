"""stf.train of the port (ref: tensorflow/python/training/training.py):
the graph optimizers and the global step, the eager flat-group optimizers
of the port's ``nn.Module`` trainers (``optimizers.FlatAdam``,
``optimizers.FlatMomentum``), and the training loop: ``Saver`` and the
checkpoint state helpers, the session-run hooks and
``MonitoredTrainingSession``."""

from .optimizer import Optimizer
from .optimizers import (AdamOptimizer, GradientDescentOptimizer,
                         MomentumOptimizer)
from .training_util import (create_global_step, get_global_step,
                            get_or_create_global_step)
from .basic_session_run_hooks import (
    CheckpointSaverHook, CheckpointSaverListener, FeedFnHook, FinalOpsHook,
    GlobalStepWaiterHook, LoggingTensorHook, NanLossDuringTrainingError,
    NanTensorHook, ProfilerHook, SecondOrStepTimer, StepCounterHook,
    StopAtStepHook, SummarySaverHook)
from .checkpoint_utils import (list_variables, load_checkpoint,
                               load_variable)
from .coordinator import Coordinator
from .monitored_session import (ChiefSessionCreator, MonitoredSession,
                                MonitoredTrainingSession, Scaffold,
                                SessionCreator, SessionManager,
                                SingularMonitoredSession,
                                WorkerSessionCreator)
from .saver import (Saver, checkpoint_exists, get_checkpoint_state,
                    latest_checkpoint, load_checkpoint_values,
                    update_checkpoint_state)
from .session_run_hook import (SessionRunArgs, SessionRunContext,
                               SessionRunHook, SessionRunValues)
