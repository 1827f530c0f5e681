"""Serving: the greedy prefill/decode engine over the ported models, the
paper's five restore strategies and their economics, and warm restore into
pre-provisioned skeletons."""
from .engine import ServerInstance, new_instance
