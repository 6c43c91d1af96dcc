"""The optimizer (port of ``repro.optim``): AdamW with the cosine
schedule and global-norm clipping, and the int8 error-feedback gradient
compression of the data-parallel step."""
from repro_torch.optim.adamw import (AdamWConfig, OptState, adamw_init,  # noqa: F401
                                     adamw_update, cosine_schedule,
                                     global_norm_clip)
from repro_torch.optim.compress import (ef_compress_pytree,  # noqa: F401
                                        ef_decompress_pytree,
                                        init_error_buffers, int8_compress,
                                        int8_decompress)
