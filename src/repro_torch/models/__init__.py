from .params import (count_params, map_axes, param_shardings, param_specs,
                     param_split, shard_params)
from .transformer import (abstract_params, cache_axes, cast_params,
                          decode_step, forward, init_cache, init_params,
                          loss_fn, param_axes, prefill, stack_plan)

__all__ = ["init_params", "cast_params", "forward", "loss_fn", "init_cache",
           "prefill", "decode_step", "stack_plan", "count_params",
           "param_axes", "abstract_params", "cache_axes", "param_specs",
           "param_shardings", "param_split", "map_axes", "shard_params"]
