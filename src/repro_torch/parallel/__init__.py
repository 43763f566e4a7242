"""Distribution over ``torch.distributed`` ranks: mesh-axis conventions,
sharding rules, the GPipe pipeline and the compressed all-reduce (the JAX
package's ``parallel``).  ``named`` / ``placements`` give a spec's DTensor
placements; ``transport`` holds every collective and its route."""
from .sharding import (DATA_AXES_SINGLE, DATA_AXES_MULTI, MODEL_AXIS,
                       data_axes, param_pspecs, batch_pspecs, cache_pspecs,
                       named, placements, zero1_pspecs, fsdp_pspecs,
                       FSDP_THRESHOLD_BYTES, sanitize_pspecs, layer_spec,
                       local_shard, gather, fsdp_seq_specs)
from .pipeline import (pipeline_apply, stage_block_counts,
                       compressed_psum)

__all__ = ["DATA_AXES_SINGLE", "DATA_AXES_MULTI", "MODEL_AXIS", "data_axes",
           "param_pspecs", "batch_pspecs", "cache_pspecs", "named",
           "placements",
           "zero1_pspecs", "fsdp_pspecs", "FSDP_THRESHOLD_BYTES",
           "pipeline_apply", "stage_block_counts", "compressed_psum",
           "sanitize_pspecs", "layer_spec", "local_shard", "gather",
           "fsdp_seq_specs"]
