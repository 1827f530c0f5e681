"""Roofline terms on the NVIDIA H100: ``analysis.movement_roofline`` for the
snapshot data plane's sweeps, and the card's rates that every bound in the
port is taken against."""
