"""Ordered key-value stores and the block store (the port's copy of
`cometbft_tpu.store`)."""
