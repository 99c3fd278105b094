"""The port's binding of the native host runtime (``runtime_cc/``)."""
