"""Quickstart on the PyTorch/CUDA port: the iCheck workflow from paper
Listing 1, step by step, against a tiny model -- register, add_adapt,
commit (async), restart, and the restored weights' forward pass
bit-identical to the original's.  The twin of ``quickstart.py``.

  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.core import ICheckClient, ICheckCluster, snapshot_pytree
from repro_torch.core.snapshot import restore_pytree
from repro_torch.models import forward, init_params


def meta_template(tree):
    """The tree's structure, shapes and dtypes on the ``meta`` device."""
    if isinstance(tree, dict):
        return {k: meta_template(v) for k, v in tree.items()}
    return torch.empty(tree.shape, dtype=tree.dtype, device="meta")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config("yi-6b", tiny=True)
    gen = torch.Generator(device=args.device).manual_seed(0)
    params = init_params(cfg, gen, device=args.device)
    tokens = torch.arange(32, dtype=torch.int32,
                          device=args.device)[None, :] % cfg.vocab_size
    batch = {"tokens": tokens}

    # an iCheck deployment: RM + controller + 2 iCheck nodes + PFS
    with ICheckCluster(n_icheck_nodes=2) as cluster:
        # 1. icheck_init: register with the controller, get agents
        client = ICheckClient("quickstart", cluster.controller).init()
        print(f"connected to {len(client.agents)} agent(s)")

        # 2. icheck_add_adapt: register every model param as a region
        snap = snapshot_pytree(params, step=0)
        client.add_adapt_snapshot(snap)
        print(f"registered {len(snap.regions)} regions, "
              f"{snap.total_bytes() / 2**20:.1f} MiB")

        # 3. icheck_commit: async transfer to agent memory (L1), then PFS
        handle = client.commit(
            step=0, parts_by_region={n: r.parts
                                     for n, r in snap.regions.items()})
        print("commit returned immediately; app keeps computing...")
        with torch.no_grad():
            logits, _ = forward(cfg, params, batch)
        handle.wait(timeout=60)
        print(f"checkpoint {handle.ckpt_id} in L1 "
              f"(simulated transfer {handle.sim_duration * 1e3:.2f} ms)")

        # 4. icheck_restart: fetch the newest checkpoint back
        meta, regions, level = client.restart()
        restored = restore_pytree(meta_template(params), regions,
                                  meta.regions, device=args.device)
        with torch.no_grad():
            logits2, _ = forward(cfg, restored, batch)
        assert torch.equal(logits, logits2)
        print(f"restored from {level}: forward pass is bit-identical")
        client.finalize()


if __name__ == "__main__":
    main()
