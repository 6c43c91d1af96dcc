"""The training runtime (port of ``repro.runtime``, single device): the
train and serve step builders, the fault-tolerant supervisor and the
checkpoint restore of the train state."""
