"""stf.train of the port (ref: tensorflow/python/training/training.py):
the graph optimizers and the global step, and the eager flat-group
optimizers of the port's ``nn.Module`` trainers (``optimizers.FlatAdam``,
``optimizers.FlatMomentum``)."""

from .optimizer import Optimizer
from .optimizers import (AdamOptimizer, GradientDescentOptimizer,
                         MomentumOptimizer)
from .training_util import (create_global_step, get_global_step,
                            get_or_create_global_step)
