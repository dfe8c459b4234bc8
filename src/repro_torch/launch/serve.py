"""Serving driver, the twin of ``repro.launch.serve`` (tiny configs).

  python -m repro_torch.launch.serve --arch yi-6b --batch 4 \
      --prompt-len 32 --gen 16 [--icheck] [--device cuda|cpu]

With --icheck, the filled KV cache is committed to agents after prefill
(serving-state fault tolerance).
"""
from __future__ import annotations

import argparse
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--icheck", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serve import ServeEngine, serve_max_len

    cfg = get_config(args.arch, tiny=True)
    gen = torch.Generator(device=args.device).manual_seed(args.seed)
    params = init_params(cfg, gen, device=args.device)
    rng = np.random.default_rng(args.seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size,
                                    (args.batch, args.prompt_len))
             .astype(np.int32)}

    engine = ServeEngine(cfg, params,
                         max_len=serve_max_len(cfg, args.prompt_len,
                                               args.gen),
                         device=args.device)
    client = None
    cluster = None
    if args.icheck:
        from repro_torch.core import ICheckCluster, ICheckClient
        cluster = ICheckCluster(n_icheck_nodes=1)
        client = ICheckClient("serve", cluster.controller).init()

    t0 = time.monotonic()
    out = engine.generate(batch, gen_len=args.gen, checkpoint_client=client)
    dt = time.monotonic() - t0
    print(f"generated {out.shape} in {dt:.2f}s "
          f"({args.batch * args.gen / dt:.1f} tok/s)")
    print("first sequence:", out[0].tolist())
    if cluster is not None:
        client.finalize()
        cluster.close()


if __name__ == "__main__":
    main()
