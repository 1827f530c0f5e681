"""The model substrate: shared layers, attention, the decoder-only families
(dense, MoE, VLM, xLSTM, the Mamba2 hybrid), the encoder-decoder and the
uniform ``Model`` interface (``build``)."""
from .model_zoo import Model, TensorSpec, build
