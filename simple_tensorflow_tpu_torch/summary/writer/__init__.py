"""Event-file writing of the port (``writer``)."""
