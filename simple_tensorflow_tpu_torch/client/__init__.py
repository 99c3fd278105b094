"""The port's Session (``client/session.py``)."""
