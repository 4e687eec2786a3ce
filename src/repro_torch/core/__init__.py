from .taskpar import (MTPConfig, MultiTaskModel, HeadPlacement,  # noqa: F401
                      TaskShard, head_rows, hier_batch_spec,
                      memory_per_device, mtp_value_and_grad_dist,
                      round_robin_placement)
from .balancing import solve_placement  # noqa: F401
from .mtl import (gfm_eval_fn, gfm_loss_terms, make_gfm_mtl,  # noqa: F401
                  make_lm_multitask, softmax_xent)
from . import balancing  # noqa: F401
