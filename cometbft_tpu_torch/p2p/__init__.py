"""Peer-to-peer seams (the port's copy of parts of `cometbft_tpu.p2p`):
the reactor interface and the channel descriptor a reactor declares.
The switch, transport and connections are not ported yet."""
