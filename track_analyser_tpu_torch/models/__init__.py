"""Model tier: the downbeat activation TCN and its host decoder."""

from . import downbeat, downbeat_net

__all__ = ["downbeat", "downbeat_net"]
