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

Launched as a process world (``RANK`` and ``WORLD_SIZE`` in the
environment, as ``torchrun`` sets them, and ``--store-dir`` a directory
every rank reaches), the ranks are real: each process joins the world
over a ``FileStore`` there (NCCL on CUDA, gloo on the CPU), the trainer
is data parallel over a mesh of ``--ranks`` of them, and a resize moves
it onto ``--new-ranks``.  Rank 0 holds the iCheck cluster and prints.

  for r in 0 1; do RANK=$r WORLD_SIZE=2 python -m repro_torch.launch.train \
      --icheck --device cpu --store-dir /tmp/world --ranks 1 --new-ranks 2 \
      --resize-at 6 --steps 12 & done; wait
"""
from __future__ import annotations

import argparse
import os
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
    ap.add_argument("--store-dir", default=None,
                    help="the FileStore directory of a launched world")
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
        world = int(os.environ.get("WORLD_SIZE", "0"))
        rank = int(os.environ.get("RANK", "0"))
        if world:
            from repro_torch.sharding import init_world
            from repro_torch.sharding.mesh import default_backend

            if args.store_dir is None:
                ap.error("a launched world (WORLD_SIZE) needs --store-dir")
            init_world(rank, world, default_backend(device), args.store_dir)
        try:
            _train_icheck(args, cfg, shape, opt_cfg, device, rank)
        finally:
            if world:
                import torch.distributed as dist

                dist.destroy_process_group()
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


def _train_icheck(args, cfg, shape, opt_cfg, device, rank):
    """The ElasticTrainer's run; rank 0 holds the cluster, schedules the
    resize and prints."""
    import contextlib

    from repro_torch.core import ICheckCluster
    from repro_torch.train import ElasticTrainer

    root = rank == 0
    with (ICheckCluster(n_icheck_nodes=2) if root
          else contextlib.nullcontext()) as cluster:
        trainer = ElasticTrainer(
            cfg, shape, cluster, ranks=args.ranks, seed=args.seed,
            opt_cfg=opt_cfg, commit_every=args.commit_every,
            total_steps=args.steps, device=device)
        if args.resize_at:
            trainer.run(args.resize_at)
            if root:
                cluster.rm.schedule_resize("train", args.new_ranks)
            rest = trainer.run(args.steps - args.resize_at)
            if root:
                print(f"[resize] {args.ranks} -> {args.new_ranks} ranks, "
                      f"resizes={trainer.resizes}")
        else:
            rest = trainer.run(args.steps)
        trainer.finalize()
        if root:
            for m in trainer.metrics_log[:3] + trainer.metrics_log[-3:]:
                print(f"step {m['step']:5d} loss {m['loss']:.4f}")
            print(f"final loss {rest['final_loss']:.4f} "
                  f"({rest['wall_s']:.1f}s)")


if __name__ == "__main__":
    main()
