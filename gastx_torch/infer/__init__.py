from gastx_torch.infer.lifting import lift_sequences, lift_to_world
from gastx_torch.infer.streaming import StreamingLifter

__all__ = ["lift_sequences", "lift_to_world", "StreamingLifter"]
