"""Multi-device code on ``torch.distributed`` (port of ``repro.distributed``).

``sharding`` (param / cache / batch placements, and moving tensors between a
rank's full view and its shard), ``axes`` (logical axes for model code, and
the groups the compute is split over), ``tensor_parallel`` (the model group
and its collectives: XLA's partitioner in the reference, no module there),
``collectives`` (int8 error-feedback all-reduce) and ``rdp`` (the paper's
policy as a ("replica", "shard", "model") mesh, and its host side).
``compat`` is jax-version code and has no counterpart.
"""
