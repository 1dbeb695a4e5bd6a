from gastx_torch.infer.lifting import lift_sequences, lift_to_world

__all__ = ["lift_sequences", "lift_to_world"]
