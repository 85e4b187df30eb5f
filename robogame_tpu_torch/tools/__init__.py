"""The port's campaign and kernel tools (the JAX package's ``tools/``):

    python -m robogame_tpu_torch.tools.<name> [arguments] [--cpu]

==============  ========================================================
dist_equiv      the fast engines (the sweep engine, K6's ``pallas`` and
                K1's ``pallas_exact``) against the event engine over
                large game populations, distributionally
bench_grind     corner grinders against the Monte-Carlo mix on K1 (one-
                or two-phase) or K6
bench_sol       K1's loop iteration cost from a sweep of its event cap
                on corner grinders, and the two-phase step's launches
reconcile_bias  the corner-grinding damage bias split into its platform
                and semantic parts, with a one-ulp control
==============  ========================================================

Each has a ``main(argv=None)`` that returns the exit code and runs on the
card; ``--cpu`` runs it on the CPU (``reconcile_bias --phase cpu`` and
``--phase compare`` need no card in any case).
"""
