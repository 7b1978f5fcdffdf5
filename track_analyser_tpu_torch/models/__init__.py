"""Model tier: the downbeat activation TCN and its host decoder, the
band-split mask net and its checkpoint resolver."""

from . import downbeat, downbeat_net, separation, separation_net

__all__ = ["downbeat", "downbeat_net", "separation", "separation_net"]
