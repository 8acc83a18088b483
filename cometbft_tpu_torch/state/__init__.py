"""Replicated state, its store, block validation and block execution
(the port's copy of `cometbft_tpu.state`)."""
