"""TFRecord I/O of the port (``tf_record``)."""
