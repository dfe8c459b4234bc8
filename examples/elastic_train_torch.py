"""Elastic training on the PyTorch/CUDA port (paper SSIII): the resource
manager grows the job mid-run; iCheck redistributes the TrainState
through its agents and training continues -- out-of-the-box
malleability, no app-side re-initialization.  The twin of
``elastic_train.py``: the ranks are logical, in one process.

  PYTHONPATH=src python examples/elastic_train_torch.py [--device cpu]
"""
import argparse

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import ICheckCluster
from repro_torch.optim import AdamWConfig
from repro_torch.train import ElasticTrainer


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config("qwen2.5-3b", tiny=True)
    shape = ShapeConfig("elastic", "train", seq_len=64, global_batch=8)

    with ICheckCluster(n_icheck_nodes=2) as cluster:
        trainer = ElasticTrainer(cfg, shape, cluster, app_id="elastic",
                                 ranks=2, seed=0,
                                 opt_cfg=AdamWConfig(lr=2e-3),
                                 commit_every=10, total_steps=60,
                                 device=args.device)
        print("phase 1: 2 ranks")
        trainer.run(20)
        l1 = trainer.metrics_log[-1]["loss"]

        print("RM grants 2 more ranks -> expand to 4 "
              "(adapt_begin / icheck_redistribute / adapt_commit)")
        cluster.rm.schedule_resize("elastic", 4)
        trainer.run(20)
        l2 = trainer.metrics_log[-1]["loss"]
        assert trainer.app.ranks == 4 and trainer.resizes == 1

        print("RM retakes 3 ranks -> shrink to 1")
        cluster.rm.schedule_resize("elastic", 1)
        trainer.run(20)
        l3 = trainer.metrics_log[-1]["loss"]
        assert trainer.app.ranks == 1 and trainer.resizes == 2

        trainer.finalize()
        print(f"loss: {trainer.metrics_log[0]['loss']:.3f} -> {l1:.3f} "
              f"-> {l2:.3f} -> {l3:.3f} across 2 resizes "
              f"(continuous trajectory)")


if __name__ == "__main__":
    main()
