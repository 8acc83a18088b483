"""The channel descriptor a reactor declares (a copy of
`ChannelDescriptor` alone from `cometbft_tpu.p2p.conn.connection`;
CometBFT p2p/conn/connection.go:748).  The multiplexed connection itself
is not ported yet."""

from __future__ import annotations

DEFAULT_SEND_QUEUE_CAPACITY = 1
DEFAULT_RECV_MESSAGE_CAPACITY = 22 * 1024 * 1024


class ChannelDescriptor:
    """connection.go:748 ChannelDescriptor."""

    def __init__(self, channel_id: int, priority: int = 1,
                 send_queue_capacity: int = DEFAULT_SEND_QUEUE_CAPACITY,
                 recv_message_capacity: int = DEFAULT_RECV_MESSAGE_CAPACITY,
                 recv_buffer_capacity: int = 4096):
        self.id = channel_id
        self.priority = max(priority, 1)
        self.send_queue_capacity = send_queue_capacity
        self.recv_message_capacity = recv_message_capacity
        self.recv_buffer_capacity = recv_buffer_capacity
