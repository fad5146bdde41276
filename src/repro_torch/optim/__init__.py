"""Optimizer and gradient compression of the training path (the port's copy
of the JAX package's ``optim/``)."""
from .adamw import (AdamWState, adamw_init, adamw_update,
                    clip_by_global_norm, cosine_schedule, global_norm)
from .compress import (EFState, dequantize_int8, ef_compress, ef_init,
                       quantize_int8)

__all__ = ["AdamWState", "adamw_init", "adamw_update", "cosine_schedule",
           "global_norm", "clip_by_global_norm", "quantize_int8",
           "dequantize_int8", "ef_compress", "EFState", "ef_init"]
