"""Serving: the greedy prefill/decode engine over the ported models."""
from .engine import ServerInstance, new_instance
