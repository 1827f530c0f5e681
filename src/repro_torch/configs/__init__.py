"""Model configurations: the ``ModelConfig`` dataclass, its registry, the
workload shapes and the ported architectures (the dense-GQA and the MoE/MLA
families)."""
