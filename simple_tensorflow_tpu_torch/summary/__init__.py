"""stf.summary of the port (ref: tensorflow/python/summary): the summary
ops (``summary.py``), ``FileWriter``/``EventsWriter`` and
``summary_iterator``."""

from .summary import (audio, histogram, image, merge, merge_all, scalar,
                      tensor_summary, text)
from .summary_iterator import summary_iterator
from .writer.writer import EventsWriter, FileWriter
