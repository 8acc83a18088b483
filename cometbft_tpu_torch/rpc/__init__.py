"""The RPC layer's JSON encoders (the port's copy of the part of
`cometbft_tpu.rpc` the light-client serving plane needs: the payload
codec's shapes).  The routes and server are not ported yet."""
