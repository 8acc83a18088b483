"""Mempool: CheckTx-gated pending-tx pool (the port's copy of
`cometbft_tpu.mempool`; CometBFT mempool/)."""

from .cache import LRUTxCache, NopTxCache  # noqa: F401
from .clist_mempool import (  # noqa: F401
    CListMempool, ErrMempoolIsFull, ErrTxInCache, ErrTxTooLarge, MempoolTx,
    NopMempool, tx_key,
)
