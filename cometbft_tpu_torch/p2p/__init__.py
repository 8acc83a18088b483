"""Peer-to-peer networking (the port's copy of `cometbft_tpu.p2p`): an
authenticated, multiplexed, rate-limited TCP mesh of SecretConnection,
MConnection, MultiplexTransport and the Switch, and the reactor
interface."""

from .base_reactor import Envelope, Reactor  # noqa: F401
from .key import NodeKey, node_id_from_pubkey  # noqa: F401
from .node_info import NodeInfo  # noqa: F401
from .switch import Switch  # noqa: F401
