"""The subset of ``simple_tensorflow_tpu/framework/errors.py`` that the
serving engine, the Session (``OutOfRangeError``: an exhausted
``run_steps`` feed iterator), the checkpoint readers (``DataLossError``: a
checksum or record CRC that does not match), the training loop and the
input pipeline (``UnimplementedError``, ``InternalError``, and
:func:`exception_type_from_error_code` for the native runtime's codes)
raise:
the same class names, codes and constructor (``Error(node_def, op,
message)`` or ``Error("message")``)."""

from __future__ import annotations

INVALID_ARGUMENT = 3
DEADLINE_EXCEEDED = 4
NOT_FOUND = 5
RESOURCE_EXHAUSTED = 8
FAILED_PRECONDITION = 9
OUT_OF_RANGE = 11
UNIMPLEMENTED = 12
INTERNAL = 13
UNAVAILABLE = 14
DATA_LOSS = 15


class OpError(Exception):
    """Base class of the engine's errors; carries an error code."""

    def __init__(self, node_def, op, message, error_code):
        super().__init__(message)
        self._node_def = node_def
        self._op = op
        self._message = message
        self._error_code = error_code

    @property
    def message(self):
        return self._message

    @property
    def op(self):
        return self._op

    @property
    def node_def(self):
        return self._node_def

    @property
    def error_code(self):
        return self._error_code


def _make(name, code, doc):
    def __init__(self, node_def=None, op=None, message=None):
        if message is None and isinstance(node_def, str):
            node_def, message = None, node_def
        OpError.__init__(self, node_def, op, message or name, code)

    return type(name, (OpError,), {"__init__": __init__, "__doc__": doc})


InvalidArgumentError = _make("InvalidArgumentError", INVALID_ARGUMENT,
                             "Op received an invalid argument.")
NotFoundError = _make("NotFoundError", NOT_FOUND,
                      "A requested entity was not found.")
FailedPreconditionError = _make("FailedPreconditionError",
                                FAILED_PRECONDITION,
                                "Operation was rejected because the system "
                                "is not in a state to execute it.")
DeadlineExceededError = _make("DeadlineExceededError", DEADLINE_EXCEEDED,
                              "Deadline expired before operation completed.")
ResourceExhaustedError = _make("ResourceExhaustedError", RESOURCE_EXHAUSTED,
                               "A resource (e.g. device memory) was "
                               "exhausted.")
UnavailableError = _make("UnavailableError", UNAVAILABLE,
                         "Runtime currently unavailable.")
OutOfRangeError = _make("OutOfRangeError", OUT_OF_RANGE,
                        "Operation tried to iterate past the valid input "
                        "range.")
DataLossError = _make("DataLossError", DATA_LOSS,
                      "Unrecoverable data loss or corruption.")
UnimplementedError = _make("UnimplementedError", UNIMPLEMENTED,
                            "Operation is not implemented or supported.")
InternalError = _make("InternalError", INTERNAL, "Internal error.")

_CODE_TO_EXC = {INVALID_ARGUMENT: InvalidArgumentError,
                DEADLINE_EXCEEDED: DeadlineExceededError,
                NOT_FOUND: NotFoundError,
                RESOURCE_EXHAUSTED: ResourceExhaustedError,
                FAILED_PRECONDITION: FailedPreconditionError,
                OUT_OF_RANGE: OutOfRangeError,
                UNIMPLEMENTED: UnimplementedError, INTERNAL: InternalError,
                UNAVAILABLE: UnavailableError, DATA_LOSS: DataLossError}


def exception_type_from_error_code(code):
    """The class of a canonical error code (``KeyError`` for a code the
    port does not raise)."""
    return _CODE_TO_EXC[code]
