"""Data-parallel training over processes (counterpart of stcd_tpu/parallel).

One process a card (torchrun, NCCL between cards, gloo on the CPU), each
holding rows ``r::W`` of the global batch. ``distributed`` holds the process
group and its collectives; ``mesh`` the ``data`` axis over the processes.
Spatial, tensor and pipeline parallelism (the JAX mesh's ``space``, ``model``
and ``stage`` axes) are not ported (ROADMAP.md Queue 1 #11)."""
