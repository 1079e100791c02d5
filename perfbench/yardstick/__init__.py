"""The benchmark's own code: what later changes to the program cannot move.

Traffic generation, the scene and weights made from the seed, the work
counts and the card's peaks, the reduction of a profile to metrics, the
plain float32 reference and the comparison that decides ``correct``. The
program under test is ``depth_lidar_nerf_tpu_torch``; only ``train`` and
``serve`` import it, and only :mod:`yardstick.reference` imports nothing of
it.
"""
