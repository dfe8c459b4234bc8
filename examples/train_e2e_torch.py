"""End-to-end driver on the PyTorch/CUDA port: train a ~100M-param
llama-family model for a few hundred steps with iCheck commits + a
mid-run simulated failure and restart (the full fault-tolerance loop).
The twin of ``train_e2e.py``.

  PYTHONPATH=src python examples/train_e2e_torch.py [--steps 300] \
      [--small] [--device cpu]
"""
import argparse
import dataclasses
import time

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import ICheckCluster
from repro_torch.optim import AdamWConfig
from repro_torch.train import ElasticTrainer


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--small", action="store_true",
                    help="~2M params instead of ~100M (fast CI)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    base = get_config("yi-6b", tiny=True)
    if args.small:
        cfg = dataclasses.replace(base, name="llama-2m")
        shape = ShapeConfig("e2e", "train", seq_len=64, global_batch=8)
    else:
        # ~100M params: 12L, d_model=512, 8 heads, d_ff=2048, 32k vocab
        cfg = dataclasses.replace(
            base, name="llama-100m", num_layers=12, d_model=512,
            num_heads=8, num_kv_heads=4, d_ff=2048, vocab_size=32768,
            dtype="float32")
        shape = ShapeConfig("e2e", "train", seq_len=128, global_batch=4)

    def trainer():
        return ElasticTrainer(cfg, shape, cluster, app_id="e2e", seed=0,
                              opt_cfg=AdamWConfig(lr=1e-3),
                              commit_every=25, probe_every=100,
                              total_steps=args.steps, device=args.device)

    with ICheckCluster(n_icheck_nodes=2) as cluster:
        trainer1 = trainer()
        n_params = sum(x.numel() for x in
                       _leaves(trainer1.state.params))
        print(f"model {cfg.name}: {n_params / 1e6:.1f}M params, "
              f"batch {shape.global_batch} x {shape.seq_len}")

        half = args.steps // 2
        t0 = time.monotonic()
        trainer1.run(half)
        print(f"[{time.monotonic() - t0:6.1f}s] step {half}: "
              f"loss {trainer1.metrics_log[-1]['loss']:.4f}")
        trainer1.commit(blocking=True)

        # simulate a crash: abandon the trainer, start a new one (restart)
        print("simulating node failure -> restart from iCheck")
        trainer2 = trainer()
        assert trainer2.restarted and int(trainer2.state.step) == half
        trainer2.run(args.steps - half)
        print(f"[{time.monotonic() - t0:6.1f}s] step {args.steps}: "
              f"loss {trainer2.metrics_log[-1]['loss']:.4f}")
        first = trainer1.metrics_log[0]["loss"]
        last = trainer2.metrics_log[-1]["loss"]
        print(f"loss {first:.3f} -> {last:.3f} "
              f"({'LEARNED' if last < first * 0.7 else 'check config'}); "
              f"restart was transparent")
        trainer2.finalize()


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    main()
