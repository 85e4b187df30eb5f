"""The port's campaign tools (the JAX package's ``tools/``):

    python -m robogame_tpu_torch.tools.dist_equiv [--games 10000]
        [--steps 100] [--json out.json] [--cpu]

``dist_equiv`` holds the port's fast engines (the sweep engine, K6's
``pallas`` and K1's ``pallas_exact``) against its event engine over large
game populations, distributionally.
"""
