"""NodeInfo: identity and capability exchange at connection upgrade (the
port's copy of `cometbft_tpu.p2p.node_info`; CometBFT p2p/node_info.go),
with its proto codec byte for byte the JAX package's."""

from __future__ import annotations

from dataclasses import dataclass, field

from ..libs import protowire as pw

MAX_NODE_INFO_SIZE = 10240


class NodeInfoError(Exception):
    pass


@dataclass
class ProtocolVersion:
    p2p: int = 9       # version/version.go P2PProtocol
    block: int = 11    # BlockProtocol
    app: int = 0

    def to_proto(self) -> bytes:
        return (pw.Writer().uvarint_field(1, self.p2p)
                .uvarint_field(2, self.block)
                .uvarint_field(3, self.app).bytes())

    @staticmethod
    def from_proto(p: bytes) -> "ProtocolVersion":
        r = pw.Reader(p)
        m = ProtocolVersion(0, 0, 0)
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1 and w == pw.VARINT:
                m.p2p = r.read_uvarint()
            elif f == 2 and w == pw.VARINT:
                m.block = r.read_uvarint()
            elif f == 3 and w == pw.VARINT:
                m.app = r.read_uvarint()
            else:
                r.skip(w)
        return m


@dataclass
class NodeInfo:
    """p2p.DefaultNodeInfo."""
    protocol_version: ProtocolVersion = field(
        default_factory=ProtocolVersion)
    node_id: str = ""
    listen_addr: str = ""
    network: str = ""          # chain id
    version: str = ""
    channels: bytes = b""
    moniker: str = ""
    # other: tx_index on/off, rpc address
    tx_index: str = "on"
    rpc_address: str = ""

    def validate_basic(self) -> None:
        if len(self.node_id) != 40:
            raise NodeInfoError(f"invalid node ID {self.node_id!r}")
        if len(self.channels) > 16:
            raise NodeInfoError("too many channels")
        if len(set(self.channels)) != len(self.channels):
            raise NodeInfoError("duplicate channel id")
        if len(self.moniker) > 255:
            raise NodeInfoError("moniker too long")

    def compatible_with(self, other: "NodeInfo") -> None:
        """node_info.go CompatibleWith: same block protocol + network,
        and at least one common channel."""
        if self.protocol_version.block != other.protocol_version.block:
            raise NodeInfoError(
                f"peer has different block protocol: "
                f"{other.protocol_version.block} vs "
                f"{self.protocol_version.block}")
        if self.network != other.network:
            raise NodeInfoError(
                f"peer is on network {other.network!r}, we are on "
                f"{self.network!r}")
        if self.channels and other.channels and not (
                set(self.channels) & set(other.channels)):
            raise NodeInfoError("no common channels")

    def to_proto(self) -> bytes:
        return (pw.Writer()
                .message_field(1, self.protocol_version.to_proto())
                .string_field(2, self.node_id)
                .string_field(3, self.listen_addr)
                .string_field(4, self.network)
                .string_field(5, self.version)
                .bytes_field(6, self.channels)
                .string_field(7, self.moniker)
                .string_field(8, self.tx_index)
                .string_field(9, self.rpc_address).bytes())

    @staticmethod
    def from_proto(p: bytes) -> "NodeInfo":
        r = pw.Reader(p)
        m = NodeInfo()
        while not r.at_end():
            f, w = r.read_tag()
            if f == 1 and w == pw.BYTES:
                m.protocol_version = ProtocolVersion.from_proto(
                    r.read_bytes())
            elif f == 2 and w == pw.BYTES:
                m.node_id = r.read_string()
            elif f == 3 and w == pw.BYTES:
                m.listen_addr = r.read_string()
            elif f == 4 and w == pw.BYTES:
                m.network = r.read_string()
            elif f == 5 and w == pw.BYTES:
                m.version = r.read_string()
            elif f == 6 and w == pw.BYTES:
                m.channels = r.read_bytes()
            elif f == 7 and w == pw.BYTES:
                m.moniker = r.read_string()
            elif f == 8 and w == pw.BYTES:
                m.tx_index = r.read_string()
            elif f == 9 and w == pw.BYTES:
                m.rpc_address = r.read_string()
            else:
                r.skip(w)
        return m
