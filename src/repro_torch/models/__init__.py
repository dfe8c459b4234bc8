from .params import count_params
from .transformer import (cast_params, decode_step, forward, init_cache,
                          init_params, prefill, stack_plan)

__all__ = ["init_params", "cast_params", "forward", "init_cache", "prefill",
           "decode_step", "stack_plan", "count_params"]
