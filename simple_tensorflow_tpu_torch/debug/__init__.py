"""stf.debug of the port: the numerics-health plane (``numerics``), the
dump directory's writer (``io_utils.FileSink``) and reader
(``analyzer.DebugDumpDir``). Left out: the debug wrapper sessions, the
command-line analyzer and the socket sinks."""

from .analyzer import DebugDumpDir, DebugTensorDatum
from .io_utils import DebugSink, FileSink, publish_debug_tensor
from .numerics import (HealthPlane, get_numerics_mode, get_plane,
                       set_numerics_mode, trainz_info)
