"""The simulation drivers the port has (the port's copy of part of
`cometbft_tpu.simnet`): the light-client fleet driver alone.  The
simulated network and its chain builders are not ported."""
