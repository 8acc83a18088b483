"""ABCI: the messages, the Application interface and the in-process
client (the port's copy of parts of `cometbft_tpu.abci`)."""
