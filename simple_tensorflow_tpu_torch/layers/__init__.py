"""Layers of the port (``simple_tensorflow_tpu/layers``) as ``nn.Module``s."""
