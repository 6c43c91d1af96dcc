from repro_torch.data.synthetic import (  # noqa: F401
    SyntheticCorpus, calibration_batch, host_shard)
