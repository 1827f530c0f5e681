"""The model substrate: shared layers, attention, the dense transformer and
the uniform ``Model`` interface (``build``)."""
from .model_zoo import Model, TensorSpec, build
