"""Training driver, the twin of ``repro.launch.train`` (tiny configs by
default; ``--full`` builds the published widths).

  python -m repro_torch.launch.train --arch yi-6b --steps 50 \
      --global-batch 8 --seq-len 64 [--icheck] [--resize-at 30 --ranks 2] \
      [--device cuda|cpu]

ARCH is any of the ten: yi-6b, qwen2.5-3b, deepseek-7b, phi3-medium-14b,
dbrx-132b, qwen3-moe-235b-a22b, rwkv6-7b, recurrentgemma-9b,
seamless-m4t-medium or pixtral-12b; the data pipeline draws the frames or
patches of the last two beside the tokens, and ``--microbatches`` splits
them with the tokens.

With --icheck, the run is driven by the ElasticTrainer: the paper's
Listing 1 control flow (register -> add_adapt -> commit/async -> probe ->
redistribute on resize), backed by an in-process iCheck cluster.
"""
from __future__ import annotations

import argparse
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--tiny", action="store_true", default=True)
    ap.add_argument("--full", dest="tiny", action="store_false")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--icheck", action="store_true")
    ap.add_argument("--commit-every", type=int, default=10)
    ap.add_argument("--resize-at", type=int, default=0,
                    help="inject an RM resize event at this step")
    ap.add_argument("--ranks", type=int, default=1)
    ap.add_argument("--new-ranks", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import SyntheticLMData
    from repro_torch.optim import AdamWConfig, warmup_cosine
    from repro_torch.train import make_train_state, make_train_step

    cfg = get_config(args.arch, tiny=args.tiny)
    shape = ShapeConfig("cli", "train", args.seq_len, args.global_batch)
    opt_cfg = AdamWConfig(lr=args.lr)
    device = torch.device(args.device)

    if args.icheck:
        from repro_torch.core import ICheckCluster
        from repro_torch.train import ElasticTrainer

        with ICheckCluster(n_icheck_nodes=2) as cluster:
            trainer = ElasticTrainer(
                cfg, shape, cluster, ranks=args.ranks, seed=args.seed,
                opt_cfg=opt_cfg, commit_every=args.commit_every,
                total_steps=args.steps, device=device)
            if args.resize_at:
                trainer.run(args.resize_at)
                cluster.rm.schedule_resize("train", args.new_ranks)
                rest = trainer.run(args.steps - args.resize_at)
                print(f"[resize] {args.ranks} -> {args.new_ranks} ranks, "
                      f"resizes={trainer.resizes}")
            else:
                rest = trainer.run(args.steps)
            trainer.finalize()
            for m in trainer.metrics_log[:3] + trainer.metrics_log[-3:]:
                print(f"step {m['step']:5d} loss {m['loss']:.4f}")
            print(f"final loss {rest['final_loss']:.4f} "
                  f"({rest['wall_s']:.1f}s)")
        return

    gen = torch.Generator(device=device).manual_seed(args.seed)
    state = make_train_state(cfg, gen, opt_cfg, device=device)
    schedule = warmup_cosine(args.lr, warmup=10, total=args.steps)
    step_fn = make_train_step(cfg, opt_cfg, schedule,
                              microbatches=args.microbatches)
    data = SyntheticLMData(cfg, shape, seed=args.seed)
    t0 = time.monotonic()
    for i in range(args.steps):
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in data.next_batch().items()}
        state, metrics = step_fn(state, batch)
        if i < 3 or i % 10 == 0 or i == args.steps - 1:
            print(f"step {i:5d} loss {float(metrics['loss']):.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f}")
    dt = time.monotonic() - t0
    print(f"{args.steps} steps in {dt:.1f}s "
          f"({args.steps * shape.global_batch * shape.seq_len / dt:.0f} tok/s)")


if __name__ == "__main__":
    main()
