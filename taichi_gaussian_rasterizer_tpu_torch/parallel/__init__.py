from .sharding import (Mesh, assemble_stripes, balance_stripe_rows,
                       dp_train_step, make_mesh, pp_project, replicate,
                       shard_leading, stripe_offsets_px, stripe_row_loads,
                       stripe_select, tp_rasterize, tp_rasterize_stripe,
                       tp_train_step, tp_train_stripe)

__all__ = ["assemble_stripes", "balance_stripe_rows", "make_mesh",
           "replicate", "shard_leading", "dp_train_step", "pp_project",
           "stripe_row_loads", "stripe_select", "tp_rasterize",
           "tp_train_step", "stripe_offsets_px", "Mesh",
           "tp_rasterize_stripe", "tp_train_stripe"]
