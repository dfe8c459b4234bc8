from .params import count_params
from .transformer import (cast_params, decode_step, forward, init_cache,
                          init_params, loss_fn, prefill, stack_plan)

__all__ = ["init_params", "cast_params", "forward", "loss_fn", "init_cache",
           "prefill", "decode_step", "stack_plan", "count_params"]
