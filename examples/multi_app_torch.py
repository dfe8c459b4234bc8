"""Multi-application checkpointing on the PyTorch/CUDA port (paper
SSII/SSIV): one iCheck instance serves a training job and a serving job
simultaneously, scaling its own nodes through the RM when memory runs out
-- system-level malleability.  The twin of ``multi_app.py``.

  PYTHONPATH=src python examples/multi_app_torch.py [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import ICheckClient, ICheckCluster
from repro_torch.models import init_params
from repro_torch.optim import AdamWConfig
from repro_torch.serve import ServeEngine
from repro_torch.train import ElasticTrainer


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    with ICheckCluster(n_icheck_nodes=1, n_spare_nodes=3,
                       node_memory=2 << 20) as cluster:
        n0 = len(cluster.controller.managers())

        # app 1: a training job with periodic commits
        cfg_t = get_config("yi-6b", tiny=True)
        trainer = ElasticTrainer(cfg_t, ShapeConfig("t", "train", 32, 4),
                                 cluster, app_id="trainer", seed=0,
                                 opt_cfg=AdamWConfig(lr=1e-3),
                                 commit_every=5, total_steps=20,
                                 device=args.device)

        # app 2: a serving job checkpointing its KV cache after prefill
        cfg_s = get_config("qwen2.5-3b", tiny=True)
        gen = torch.Generator(device=args.device).manual_seed(1)
        params = init_params(cfg_s, gen, device=args.device)
        engine = ServeEngine(cfg_s, params, max_len=64, device=args.device)
        serve_client = ICheckClient("server", cluster.controller).init()

        trainer.run(10)
        engine.generate(
            {"tokens": np.arange(16, dtype=np.int32)[None, :].repeat(2, 0)},
            gen_len=8, checkpoint_client=serve_client)
        trainer.run(10)

        # serve's commit is async: give its transfer a moment to land
        for _ in range(50):
            if cluster.controller.latest_restartable("server"):
                break
            time.sleep(0.1)

        n1 = len(cluster.controller.managers())
        for app in ("trainer", "server"):
            found = cluster.controller.latest_restartable(app)
            assert found is not None, app
            print(f"app {app!r}: newest checkpoint step={found[0].step} "
                  f"({found[1]}), agents="
                  f"{len(cluster.controller.agents_for(app))}")
        print(f"iCheck nodes: {n0} -> {n1} "
              f"(controller grew via the RM when memory ran short)")
        trainer.finalize()
        serve_client.finalize()


if __name__ == "__main__":
    main()
