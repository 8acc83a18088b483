"""Example ABCI applications (the port's copy of `cometbft_tpu.apps`'s
kvstore)."""
