"""BAD (SL005): a rank-2 padded slot table broadcasts against a rank-1
clean per-channel tensor — every channel column inherits the dead slots
silently, and nothing downstream knows the result is padded."""
import torch


def _train_slots(x, b):
    """Producer stub with the 8-slot-chunk trainer's name and contract."""
    return x


def widen_padding(b, k):
    padded = _train_slots(torch.zeros((b, k)), b)   # (B, K), dead slots
    channel_scale = torch.ones((k,))                # (K,), clean
    return padded * channel_scale                   # SL005: rank 2 vs 1
