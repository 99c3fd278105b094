"""stf.layers of the port (ref: tensorflow/python/layers): the graph
layers, and the eager ``nn.Module`` layers of the port's models
(``DenseModule``, ``Conv2DModule``, ``BatchNormalizationModule``)."""

from .base import Layer
from .convolutional import Conv2D, conv2d
from .core import Dense, Flatten, dense, flatten
from .normalization import BatchNormalization, batch_normalization
from .pooling import MaxPooling2D, max_pooling2d
