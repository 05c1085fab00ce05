"""Tensor- and expert-parallel serving over a ("data", "model") mesh (the
port of ``repro/distributed``): ``sharding`` (the logical-axis rules and
each rank's local shards) and ``collectives`` (the layout chooser's ring
terms and ``tp_matmul``).  The submodules are imported where used: the
model code imports ``collectives``, and ``sharding`` reads the model."""
