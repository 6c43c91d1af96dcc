from repro_torch.checkpoint.manager import (CheckpointManager,  # noqa: F401
                                            load_pytree, save_pytree)
