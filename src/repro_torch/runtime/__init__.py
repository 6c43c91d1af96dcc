"""The runtime (port of ``repro.runtime``): the train and serve step
functions (``step``), the fault-tolerant supervisor and the checkpoint
restore of the train state on one device; the sharding planner, the
process mesh and its explicit collectives for tensor-parallel serving
(``sharding``, ``mesh``, ``meshctx``)."""
