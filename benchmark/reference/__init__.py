"""The benchmark's plain reference: a frozen copy, in plain PyTorch and numpy,
of what a progressive K1 render computes.

- :mod:`.rng`: PCG4D and the pass seeds;
- :mod:`.scene`: the scene parser, the scene's preparation (camera basis,
  inverses, light table) and its packing into K1's float vector;
- :mod:`.walk`: the path-tracing lane loop of one or more passes, vectorised
  over lanes, and the image of a batch of passes.

It imports neither ``jax`` nor the JAX package nor anything of the port: it
parses the scene file itself and works out again everything the port
derives from it. The benchmark runs it on the card once a run's window has
closed, on the batches the run checks.
"""
