"""The port's serving engine and snapshot bridge held against the JAX
reference: greedy tokens, serving-state checkpointing through iCheck, and
snapshot regions that match the reference's byte for byte."""
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import snapshot_pytree as jax_snapshot_pytree  # noqa: E402
from repro.models import init_cache as jax_init_cache  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import prefill as jax_prefill  # noqa: E402
from repro.serve import ServeEngine as JaxServeEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import ICheckClient, ICheckCluster  # noqa: E402
from repro_torch.core.snapshot import (restore_pytree,  # noqa: E402
                                       snapshot_pytree)
from repro_torch.models.attention import KVCache  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.serve import ServeEngine, serve_max_len  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
SRC = str(Path(__file__).resolve().parents[1] / "src")


def _tokens(cfg, seed, shape):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _shared_params(arch):
    jcfg = jax_get_config(arch, tiny=True)
    jparams, _ = jax_init_params(jcfg, jax.random.key(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, get_config(arch, tiny=True), jparams, params


def test_generate_matches_reference_tokens():
    jcfg, cfg, jparams, params = _shared_params("yi-6b")
    b, t, gen = 2, 16, 8
    toks = _tokens(cfg, 11, (b, t))
    max_len = serve_max_len(cfg, t, gen)
    want = JaxServeEngine(jcfg, jparams, max_len=max_len).generate(
        {"tokens": toks}, gen_len=gen)
    got = ServeEngine(cfg, params, max_len=max_len, device="cpu").generate(
        {"tokens": toks}, gen_len=gen)
    np.testing.assert_array_equal(got, want)


def test_serving_state_checkpoint():
    """Twin of the reference's test, plus: the restored cache is
    bit-equal to the committed one, and decoding from it gives the live
    run's tokens."""
    cfg = get_config("qwen2.5-3b", tiny=True)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = {"tokens": _tokens(cfg, 5, (2, 8))}
    with ICheckCluster(n_icheck_nodes=1) as cluster:
        client = ICheckClient("serve", cluster.controller).init()
        eng = ServeEngine(cfg, params, max_len=32, device="cpu")
        out = eng.generate(batch, gen_len=4, checkpoint_client=client)
        assert out.shape == (2, 4)
        eng.last_commit.wait(timeout=60)
        found = cluster.controller.latest_restartable("serve")
        assert found is not None           # the cache checkpoint landed

        restored = eng.restore_serving_state(client, batch_size=2)
        _, fresh = eng.prefill(batch)
        for got, want in ((restored["stack"]["b0"]["self"].k,
                           fresh["stack"]["b0"]["self"].k),
                          (restored["stack"]["b0"]["self"].v,
                           fresh["stack"]["b0"]["self"].v),
                          (restored["idx"], fresh["idx"])):
            assert got.dtype == want.dtype and got.shape == want.shape
            assert torch.equal(got, want)
        cont = eng.decode_greedy(restored, out[:, :1], 3)
        np.testing.assert_array_equal(cont, out[:, 1:])
        client.finalize()


def test_serving_state_checkpoint_moe():
    """Tiny dbrx-132b: the KV cache committed after prefill is restored
    bit-equal to a second prefill's, and decoding from it gives the live
    run's tokens."""
    from repro_torch.core.snapshot import _flatten, _leaf_name

    cfg = get_config("dbrx-132b", tiny=True)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = {"tokens": _tokens(cfg, 6, (2, 12))}
    with ICheckCluster(n_icheck_nodes=1) as cluster:
        client = ICheckClient("serve", cluster.controller).init()
        eng = ServeEngine(cfg, params, max_len=20, device="cpu")
        out = eng.generate(batch, gen_len=6, checkpoint_client=client)
        eng.last_commit.wait(timeout=60)
        restored = eng.restore_serving_state(client, batch_size=2)
        _, fresh = eng.prefill(batch)
        got, want = list(_flatten(restored)), list(_flatten(fresh))
        assert [p for p, _ in got] == [p for p, _ in want]
        for (path, g), (_, w) in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w), _leaf_name(path)
        cont = eng.decode_greedy(restored, out[:, :1], 5)
        np.testing.assert_array_equal(cont, out[:, 1:])
        client.finalize()


def test_restore_without_commit_is_none():
    cfg = get_config("yi-6b", tiny=True)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with ICheckCluster(n_icheck_nodes=1) as cluster:
        client = ICheckClient("serve", cluster.controller).init()
        eng = ServeEngine(cfg, params, max_len=16, device="cpu")
        assert eng.restore_serving_state(client, batch_size=2) is None
        client.finalize()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_snapshot_regions_match_reference(dtype):
    """The same cache, snapshot by JAX and by the port: the same region
    names, shapes and bytes.  bf16 regions are named ``bfloat16`` by the
    reference and ``uint16`` (their bits) by the port."""
    jcfg = jax_get_config("yi-6b", tiny=True)
    jparams, _ = jax_init_params(jcfg, jax.random.key(0))
    toks = _tokens(jcfg, 2, (2, 8))
    _, jcache = jax_prefill(jcfg, jparams, {"tokens": toks},
                            jax_init_cache(jcfg, 2, 12))
    jcache = jax.tree.map(lambda x: x.astype(getattr(jnp, dtype))
                          if x.dtype == jnp.float32 else x, jcache)
    kv = jcache["stack"]["b0"]["self"]

    def to_port(x):
        a = np.asarray(x)
        if dtype == "bfloat16" and a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(np.array(a))

    cache = {"stack": {"b0": {"self": KVCache(k=to_port(kv.k),
                                              v=to_port(kv.v))}},
             "tails": [], "idx": to_port(jcache["idx"])}
    want = jax_snapshot_pytree(jcache)
    got = snapshot_pytree(cache)
    assert list(got.regions) == list(want.regions) == \
        ["idx", "stack/b0/self/k", "stack/b0/self/v"]
    for name, w in want.regions.items():
        g = got.regions[name]
        assert g.meta.shape == w.meta.shape
        assert g.boxes == w.boxes
        gp, wp = g.meta.partition, w.meta.partition    # two copies' classes
        assert (gp.scheme.value, gp.axis, gp.num_parts, gp.block,
                gp.bounds) == (wp.scheme.value, wp.axis, wp.num_parts,
                               wp.block, wp.bounds)
        assert g.meta.nbytes == w.meta.nbytes
        want_dtype = "uint16" if w.meta.dtype == "bfloat16" else w.meta.dtype
        assert g.meta.dtype == want_dtype
        assert g.parts[0].tobytes() == np.asarray(w.parts[0]).tobytes()
    assert got.regions["idx"].meta.shape == ()


def test_q8_codecs_name_next_slice():
    """The q8 codecs came with the training slice: a float leaf is encoded
    (its raw bytes never reach the host), a bf16 one is recorded as f32 for
    numpy's sake, ints travel raw, and an unknown codec raises."""
    snap = snapshot_pytree({"w": torch.zeros(4),
                            "h": torch.ones(3, dtype=torch.bfloat16),
                            "i": torch.tensor(2)}, codec="q8")
    assert snap.regions["w"].encoded is not None and not snap.regions["w"].parts
    assert snap.regions["h"].meta.dtype == "float32"
    assert snap.regions["h"].encoded.raw_nbytes == 6
    assert snap.regions["i"].encoded is None
    with pytest.raises(ValueError, match="codec"):
        snapshot_pytree({"w": torch.zeros(4)}, codec="zstd")


def test_bf16_roundtrip_without_ml_dtypes():
    """bf16 cache through commit -> restart -> restore with ml_dtypes
    unimportable, as on a machine without jax: the bits come back."""
    script = textwrap.dedent("""
        import sys
        sys.modules["ml_dtypes"] = None
        import torch
        from repro_torch.core import ICheckClient, ICheckCluster
        from repro_torch.core.snapshot import restore_pytree, snapshot_pytree
        from repro_torch.models.attention import KVCache

        g = torch.Generator().manual_seed(0)
        k = torch.randn((2, 2, 2, 8, 16), generator=g).to(torch.bfloat16)
        v = torch.randn((2, 2, 2, 8, 16), generator=g).to(torch.bfloat16)
        cache = {"stack": {"b0": {"self": KVCache(k=k, v=v)}}, "tails": [],
                 "idx": torch.tensor(5, dtype=torch.int32)}
        with ICheckCluster(n_icheck_nodes=1) as cluster:
            client = ICheckClient("serve", cluster.controller).init()
            snap = snapshot_pytree(cache)
            assert snap.regions["stack/b0/self/k"].meta.dtype == "uint16"
            client.add_adapt_snapshot(snap)
            client.commit(0, {n: r.parts for n, r in snap.regions.items()},
                          blocking=True)
            meta, regions, _ = client.restart()
            back = restore_pytree(cache, regions,
                                  {n: meta.regions[n] for n in regions})
            client.finalize()
        kv = back["stack"]["b0"]["self"]
        assert kv.k.dtype == torch.bfloat16 and torch.equal(kv.k, k)
        assert torch.equal(kv.v, v) and kv.ks is None
        assert back["idx"].dtype == torch.int32 and int(back["idx"]) == 5
        assert back["tails"] == []
        assert "ml_dtypes" not in {m for m, x in sys.modules.items() if x}
        print("ok")
    """)
    proc = subprocess.run([sys.executable, "-c", script], cwd=SRC,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def test_serve_cli_on_cpu(capsys):
    from repro_torch.launch.serve import main

    main(["--arch", "yi-6b", "--batch", "2", "--prompt-len", "8", "--gen",
          "4", "--icheck", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "generated (2, 4)" in out and "first sequence:" in out


@pytest.mark.parametrize("arch", ["dbrx-132b", "qwen3-moe-235b-a22b"])
def test_serve_cli_moe_on_cpu(capsys, arch):
    from repro_torch.launch.serve import main

    main(["--arch", arch, "--icheck", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "generated (4, 16)" in out and "first sequence:" in out


# ------------------------------------------------- frames / patches models
FRONTEND_ARCHS = ["seamless-m4t-medium", "pixtral-12b"]


def _modal_batch(cfg, seed, b, t):
    """Tokens, and the encoder-decoder's frames or the VLM's patches."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": _tokens(cfg, seed, (b, t))}
    if cfg.frontend == "frames":
        batch["frames"] = rng.standard_normal(
            (b, cfg.num_frames, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "patches":
        batch["patches"] = rng.standard_normal(
            (b, cfg.num_patches, cfg.d_model)).astype(np.float32)
    return batch


@pytest.mark.parametrize("arch", FRONTEND_ARCHS)
def test_generate_matches_reference_tokens_frontends(arch):
    """The engine passes the frames / patches on: the reference's greedy
    tokens from the same weights and inputs."""
    jcfg, cfg, jparams, params = _shared_params(arch)
    b, t, gen = 2, 16, 8
    batch = _modal_batch(cfg, 12, b, t)
    max_len = serve_max_len(cfg, t, gen)
    want = JaxServeEngine(jcfg, jparams, max_len=max_len).generate(
        batch, gen_len=gen)
    got = ServeEngine(cfg, params, max_len=max_len, device="cpu").generate(
        batch, gen_len=gen)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arch", FRONTEND_ARCHS)
def test_serving_state_checkpoint_frontends(arch):
    """The committed cache's regions are named as the reference's (the
    encoder-decoder's ``cross`` leaves among them), it is restored
    bit-equal to a second prefill's, and decoding from it gives the live
    run's tokens."""
    from repro_torch.core.snapshot import _flatten, _leaf_name

    jcfg, cfg, jparams, params = _shared_params(arch)
    batch = _modal_batch(cfg, 7, 2, 12)
    max_len = serve_max_len(cfg, 12, 6)
    _, jcache = jax_prefill(jcfg, jparams, batch,
                            jax_init_cache(jcfg, 2, max_len))
    with ICheckCluster(n_icheck_nodes=1) as cluster:
        client = ICheckClient("serve", cluster.controller).init()
        eng = ServeEngine(cfg, params, max_len=max_len, device="cpu")
        out = eng.generate(batch, gen_len=6, checkpoint_client=client)
        eng.last_commit.wait(timeout=60)
        restored = eng.restore_serving_state(client, batch_size=2)
        names = list(snapshot_pytree(restored).regions)
        assert names == list(jax_snapshot_pytree(jcache).regions)
        if cfg.is_encdec:
            assert {"stack/b0/cross/k", "stack/b0/cross/v"} <= set(names)
        _, fresh = eng.prefill(batch)
        got, want = list(_flatten(restored)), list(_flatten(fresh))
        assert [p for p, _ in got] == [p for p, _ in want]
        for (path, g), (_, w) in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w), _leaf_name(path)
        cont = eng.decode_greedy(restored, out[:, :1], 5)
        np.testing.assert_array_equal(cont, out[:, 1:])
        client.finalize()


@pytest.mark.parametrize("arch", FRONTEND_ARCHS)
def test_serve_cli_frontends_on_cpu(capsys, arch):
    from repro_torch.launch.serve import main

    main(["--arch", arch, "--icheck", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "generated (4, 16)" in out and "first sequence:" in out
