"""Framework-neutral host libraries of the port: CRC32-C, the TFRecord
container and the protobuf wire codec (copies of the JAX package's
``lib/crc32c.py``, ``lib/io/tf_record.py`` and ``lib/proto.py``)."""
