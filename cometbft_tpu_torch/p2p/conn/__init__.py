"""Connection machinery (the port's copy of `cometbft_tpu.p2p.conn`):
SecretConnection and MConnection."""

from .connection import ChannelDescriptor, MConnection  # noqa: F401
from .secret_connection import SecretConnection  # noqa: F401
