"""Reactor interface (the port's copy of `cometbft_tpu.p2p.base_reactor`;
CometBFT p2p/base_reactor.go).

A reactor owns a set of channels on the Switch and reacts to peer
lifecycle + incoming envelopes.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..libs.service import BaseService


@dataclass
class Envelope:
    """p2p.Envelope: a decoded message from (or to) a peer."""
    src: object = None        # Peer (inbound)
    message: object = None    # decoded message (or raw bytes)
    channel_id: int = 0
    tctx: object = None       # trace context (libs/tracetl.py) when the
    #                           wire carried one; None everywhere else


class Reactor(BaseService):
    """Override get_channels / init_peer / add_peer / remove_peer /
    receive."""

    def __init__(self, name: str = ""):
        super().__init__(name or type(self).__name__)
        self.switch = None

    def set_switch(self, switch) -> None:
        self.switch = switch

    def get_channels(self) -> list:
        """-> list[ChannelDescriptor]."""
        return []

    def init_peer(self, peer) -> object:
        """Called before the peer starts; may attach per-peer state."""
        return peer

    def add_peer(self, peer) -> None:
        pass

    def remove_peer(self, peer, reason) -> None:
        pass

    def receive(self, envelope: Envelope) -> None:
        pass
