"""Data-parallel, spatial, pipeline and tensor-parallel training over
processes (counterpart of stcd_tpu/parallel).

One process a card (torchrun, NCCL between cards, gloo on the CPU).
``distributed`` holds the process group and its collectives; ``mesh`` the
``data`` x ``model`` x ``space`` x ``stage`` grid over the processes: a data
shard holds rows ``d::D`` of the global batch, and the ranks of a space
group each hold a strip of its images' rows; ``spatial`` the halo exchange
and the spatial steps; ``pipeline`` the GPipe schedule of the ``stage`` axis,
whose S ranks hold the same rows and run one stage each; ``tensor`` the
splits of the ``model`` axis, whose T ranks hold the same rows (or strip)
and each a shard of the wide parameters. A space axis composes with a model
axis; beside a stage axis it raises, as JAX has no step for it."""
