"""``stf.data`` of the port: the input pipeline (ref: python/training/
input.py; the Dataset API of later TF); the port's copy of
``simple_tensorflow_tpu/data/``.

The pipeline runs on the host (numpy), compiled into a parallel stage
pipeline (``data/pipeline.py``): sharded native TFRecord reads,
shared-pool parallel ``map``, ``interleave``, autotuned ``prefetch``;
``prefetch_to_device`` stages batches through pinned host slots onto the
card on a side stream (``data/staging.py``). ``AUTOTUNE`` lets the
per-pipeline autotuner size a stage's parallelism (docs/DATA.md).
"""

from . import pipeline
from .dataset import (AUTOTUNE, Dataset, Iterator, TFRecordDataset,
                      make_one_shot_iterator)
