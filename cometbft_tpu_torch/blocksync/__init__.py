"""Block sync (fast sync): catch up by downloading committed blocks from
peers (the port's copy of `cometbft_tpu.blocksync`; CometBFT
internal/blocksync/), their LastCommits verified on the card."""

from .pool import BlockPool  # noqa: F401
from .reactor import BlocksyncReactor  # noqa: F401
