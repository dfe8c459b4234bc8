"""Serving demo on the PyTorch/CUDA port: batched greedy generation across
four model families (dense / SSM / hybrid / enc-dec), with KV-cache vs
recurrent-state size printed -- the O(1)-state property that makes
long_500k decodable.  The twin of ``serve_demo.py``.

  PYTHONPATH=src python examples/serve_demo_torch.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import init_cache, init_params
from repro_torch.serve import ServeEngine, serve_max_len


def cache_bytes(cfg, batch, max_len):
    """Bytes of a cache of ``max_len`` slots, allocating nothing."""
    def walk(tree):
        if isinstance(tree, dict):
            return sum(walk(v) for v in tree.values())
        if isinstance(tree, (list, tuple)):
            return sum(walk(v) for v in tree if v is not None)
        return tree.numel() * tree.element_size()
    return walk(init_cache(cfg, batch, max_len, device="meta"))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    rng = np.random.default_rng(0)
    for arch in ("yi-6b", "rwkv6-7b", "recurrentgemma-9b",
                 "seamless-m4t-medium"):
        cfg = get_config(arch, tiny=True)
        gen = torch.Generator(device=args.device).manual_seed(0)
        params = init_params(cfg, gen, device=args.device)
        b, t, n_gen = 2, 16, 12
        batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, t))
                 .astype(np.int32)}
        if cfg.frontend == "frames":
            batch["frames"] = rng.standard_normal(
                (b, cfg.num_frames, cfg.d_model)).astype(np.float32)
        engine = ServeEngine(cfg, params,
                             max_len=serve_max_len(cfg, t, n_gen),
                             device=args.device)
        out = engine.generate(batch, gen_len=n_gen)
        short = cache_bytes(cfg, b, 32)
        long = cache_bytes(cfg, b, 4096)
        growth = long / short
        kind = "O(1) state" if growth < 2 else "KV cache grows with T"
        print(f"{arch:22s} generated {out.shape}; state @T=32: "
              f"{short / 2**10:7.1f}KiB  @T=4096: {long / 2**10:9.1f}KiB  "
              f"({kind})")


if __name__ == "__main__":
    main()
