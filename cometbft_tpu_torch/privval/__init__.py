"""Validator key management (the port's copy of `cometbft_tpu.privval`;
CometBFT privval/)."""

from .file import FilePV, LastSignState  # noqa: F401
