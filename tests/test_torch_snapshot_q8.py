"""The port's device snapshot with the q8 / q8-delta codecs (the plain
codec on CPU tensors), held against the reference.

Twins of ``tests/test_delta_codec.py``'s device-encode cases (codec
gauges, delta commit + restart, a stale encode falling back to a
keyframe), through the port's copied iCheck service.  The same numpy
trees, keyframe then delta, give the port's frames and scales byte for
byte equal to the reference's wire codec (``repro.core.tiers``, numpy);
against ``repro.core.snapshot_pytree`` (XLA) they agree in layout and
within the codec kernels' stated tolerance, since XLA computes the scale
as ``absmax * (1/127)``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import ICheckClient as JaxClient  # noqa: E402
from repro.core import ICheckCluster as JaxCluster  # noqa: E402
from repro.core import snapshot_pytree as jax_snapshot  # noqa: E402
from repro_torch.core import ICheckClient, ICheckCluster  # noqa: E402
from repro_torch.core.snapshot import (describe_pytree,  # noqa: E402
                                       load_pytree_, snapshot_pytree)


@pytest.fixture
def cluster(tmp_path):
    c = ICheckCluster(n_icheck_nodes=2, n_spare_nodes=2,
                      node_memory=256 << 20, pfs_root=str(tmp_path / "pfs"),
                      adaptive_interval=False)
    yield c
    c.close()


def test_device_q8_snapshot_feeds_codec_gauges(cluster):
    client = ICheckClient("app", cluster.controller, ranks=1,
                          codec="q8").init()
    data = np.random.default_rng(9).standard_normal(1 << 14) \
        .astype(np.float32)
    snap = snapshot_pytree({"w": torch.from_numpy(data)}, step=0,
                           codec="q8")
    client.commit_snapshot(snap, blocking=True, drain=False)
    tel = cluster.telemetry.snapshot()["per_app"]["app"]
    assert tel["codec_raw_bytes"] == data.nbytes
    assert 3.5 < tel["codec_compression_ratio"] < 4.5
    client.finalize()


def test_device_snapshot_delta_commit_and_restart(cluster):
    client = ICheckClient("app", cluster.controller, ranks=1,
                          codec="q8-delta").init()
    rng = np.random.default_rng(11)
    tree = {"w": torch.from_numpy(rng.standard_normal(700)
                                  .astype(np.float32)),
            "n_steps": torch.tensor(3, dtype=torch.int32)}
    snap = snapshot_pytree(tree, step=0, codec="q8-delta",
                           chain_lookup=client.delta_chain_lookup)
    enc = snap.regions["w"].encoded
    assert enc is not None and enc.frame == "key" \
        and not snap.regions["w"].parts
    assert snap.regions["n_steps"].encoded is None      # ints travel raw
    client.commit_snapshot(snap, blocking=True, drain=False)

    tree["w"] = tree["w"].clone()
    tree["w"][:4] += 1.0
    snap2 = snapshot_pytree(tree, step=1, codec="q8-delta",
                            chain_lookup=client.delta_chain_lookup)
    enc2 = snap2.regions["w"].encoded
    assert enc2.frame == "delta" and enc2.parent_chain == (0,)
    assert sum(map(len, enc2.blobs.values())) < \
        sum(map(len, enc.blobs.values())) / 2
    h = client.commit_snapshot(snap2, blocking=True, drain=False)
    assert h.meta.regions["w"].chain == (0, 1)

    meta, out, _ = client.restart()
    assert meta.step == 1
    w = out["w"][0]
    bound = np.abs(tree["w"].numpy()).max() / 127 * 0.51
    assert np.abs(w - tree["w"].numpy()).max() <= bound
    assert out["n_steps"][0] == 3

    # the restored parts load into a live tree in place
    live = {"w": torch.zeros(700), "n_steps": torch.tensor(0, dtype=torch.int32)}
    load_pytree_(live, {k: v for k, v in out.items()},
                 {k: meta.regions[k] for k in out})
    np.testing.assert_array_equal(live["w"].numpy(), w)
    assert int(live["n_steps"]) == 3

    tel = cluster.telemetry.snapshot()["per_app"]["app"]
    assert tel["delta_key_frames"] >= 1 and tel["delta_delta_frames"] >= 1
    assert tel["codec_compression_ratio"] > 3.0
    client.finalize()


def test_stale_device_encode_falls_back_to_keyframe(cluster):
    client = ICheckClient("app", cluster.controller, ranks=1,
                          codec="q8-delta").init()
    tree = {"w": torch.ones(300)}
    client.commit_snapshot(snapshot_pytree(
        tree, step=0, codec="q8-delta",
        chain_lookup=client.delta_chain_lookup), blocking=True, drain=False)
    snap = snapshot_pytree(tree, step=1, codec="q8-delta",
                           chain_lookup=client.delta_chain_lookup)
    assert snap.regions["w"].encoded.frame == "delta"
    # the chain moves underneath (another commit of the same region)
    client.commit_snapshot(snapshot_pytree(
        tree, step=1, codec="q8-delta",
        chain_lookup=client.delta_chain_lookup), blocking=True, drain=False)
    h = client.commit_snapshot(snap, blocking=True, drain=False)
    assert h.meta.regions["w"].frame == "key"
    assert h.meta.regions["w"].chain == (h.meta.ckpt_id,)
    meta, out, _ = client.restart()
    np.testing.assert_allclose(out["w"][0], np.ones(300, np.float32),
                               atol=1 / 127)
    client.finalize()


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": {"w": rng.standard_normal((37, 40)).astype(np.float32),
                  "h": rng.standard_normal(513).astype(np.float16)},
            "b": (rng.standard_normal(256) * 5).astype(np.float32),
            "n": np.asarray(7, np.int32)}


def _trees():
    t0, t1 = _tree(0), _tree(0)
    t1["a"]["w"][3, :5] += 1.0          # one changed block
    t1["b"] = t1["b"] * 2               # every block of "b" changes
    return t0, t1


def _leaves(tree):
    return {"a/h": tree["a"]["h"], "a/w": tree["a"]["w"], "b": tree["b"],
            "n": tree["n"]}


def _port_snapshots(codec, client):
    snaps = []
    for step, tree in enumerate(_trees()):
        dev = {"a": {k: torch.from_numpy(v.copy())
                     for k, v in tree["a"].items()},
               "b": torch.from_numpy(tree["b"].copy()),
               "n": torch.from_numpy(tree["n"].copy())}
        snap = snapshot_pytree(dev, step=step, codec=codec,
                               chain_lookup=client.delta_chain_lookup)
        client.commit_snapshot(snap, blocking=True, drain=False)
        snaps.append(snap)
    return snaps


@pytest.mark.parametrize("codec", ["q8", "q8-delta"])
def test_frames_byte_identical_to_reference_host_codec(cluster, codec):
    """Key then delta: the port's device-path frames and scales equal, byte
    for byte, what the reference's wire codec (``repro.core.tiers``, numpy)
    makes of the same values."""
    from repro.core.tiers import encode_delta_region, encode_payload

    client = ICheckClient("app", cluster.controller, ranks=1,
                          codec=codec).init()
    snaps = _port_snapshots(codec, client)
    prev = {}
    for snap, tree in zip(snaps, _trees()):
        for name, x in _leaves(tree).items():
            r = snap.regions[name]
            if x.dtype.kind != "f":
                assert r.encoded is None and r.parts[0].tobytes() == \
                    x.tobytes()
                continue
            assert r.meta.dtype == str(x.dtype)
            assert r.encoded.raw_nbytes == x.nbytes
            if codec == "q8":
                assert r.encoded.blobs == {
                    0: encode_payload(x.tobytes(), "q8", str(x.dtype))}
                continue
            blobs, states, frame = encode_delta_region(
                {0: x.tobytes()}, str(x.dtype), prev.get(name))
            prev[name] = states
            assert (r.encoded.frame, r.encoded.blobs) == (frame, blobs)
            assert r.encoded.states[0].scales.tobytes() == \
                states[0].scales.tobytes()
            np.testing.assert_array_equal(r.encoded.states[0].codes,
                                          states[0].codes)
    if codec == "q8-delta":
        assert snaps[1].regions["a/w"].encoded.frame == "delta"
        assert snaps[1].regions["b"].encoded.frame == "key"
    client.finalize()


@pytest.mark.parametrize("codec", ["q8", "q8-delta"])
def test_frames_match_reference_device_snapshot(tmp_path, cluster, codec):
    """The same trees through ``repro.core.snapshot_pytree`` (XLA on the
    CPU): the same regions, frame kinds and frame layout; codes within one
    step on fewer than 1e-3 of the values and scales to rtol 1e-6 (XLA
    turns ``absmax / 127`` into ``absmax * (1/127)``, ROADMAP section 3);
    both restores within the codec's bound of the committed values."""
    client = ICheckClient("app", cluster.controller, ranks=1,
                          codec=codec).init()
    port = _port_snapshots(codec, client)
    _, port_out, _ = client.restart()
    client.finalize()
    with JaxCluster(n_icheck_nodes=2, node_memory=64 << 20,
                    pfs_root=str(tmp_path / "jax"),
                    adaptive_interval=False) as c:
        jclient = JaxClient("app", c.controller, ranks=1, codec=codec).init()
        ref = []
        for step, tree in enumerate(_trees()):
            dev = {"a": {k: jnp.asarray(v) for k, v in tree["a"].items()},
                   "b": jnp.asarray(tree["b"]), "n": jnp.asarray(tree["n"])}
            snap = jax_snapshot(dev, step=step, codec=codec,
                                chain_lookup=jclient.delta_chain_lookup,
                                impl="xla")
            jclient.commit_snapshot(snap, blocking=True, drain=False)
            ref.append(snap)
        _, ref_out, _ = jclient.restart()
        jclient.finalize()
    last = _leaves(_trees()[1])
    for ps, rs in zip(port, ref):
        assert list(ps.regions) == list(rs.regions)
        for name, pr in ps.regions.items():
            rr = rs.regions[name]
            assert (pr.meta.shape, pr.meta.dtype, pr.meta.nbytes) == \
                (rr.meta.shape, rr.meta.dtype, rr.meta.nbytes)
            if pr.encoded is None:
                assert rr.encoded is None
                continue
            pe, re_ = pr.encoded, rr.encoded
            assert (pe.frame, pe.raw_nbytes) == (re_.frame, re_.raw_nbytes)
            for part, blob in pe.blobs.items():
                other = re_.blobs[part]
                assert blob[:9] == other[:9] and len(blob) == len(other)
            if pe.states is not None:
                pq, rq = pe.states[0].codes, re_.states[0].codes
                diff = np.abs(pq.astype(np.int32) - rq.astype(np.int32))
                assert diff.max() <= 1 and (diff != 0).mean() < 1e-3
                np.testing.assert_allclose(pe.states[0].scales,
                                           re_.states[0].scales, rtol=1e-6)
    for name, x in last.items():
        x = x.astype(np.float32)
        bound = np.abs(x).max() / 127 * 0.51 + 1e-3
        for out in (port_out, ref_out):
            got = out[name][0].astype(np.float32).reshape(x.shape)
            assert np.abs(got - x).max() <= bound, name


def test_describe_pytree_names_regions_without_a_copy():
    tree = {"z": torch.zeros(3, 4, dtype=torch.bfloat16),
            "a": [torch.ones(2), torch.tensor(1, dtype=torch.int32)]}
    desc = describe_pytree(tree)
    raw = snapshot_pytree(tree)
    assert list(desc.regions) == list(raw.regions) == ["a/0", "a/1", "z"]
    for name, r in desc.regions.items():
        m = raw.regions[name].meta
        assert not r.parts
        assert (r.meta.shape, r.meta.dtype, r.meta.nbytes) == \
            (m.shape, m.dtype, m.nbytes)


@pytest.mark.parametrize("changed", [0, 1, 252, 253])
def test_device_frame_choice_equals_packer(changed):
    """The delta-or-keyframe choice the snapshot makes from the device's
    dense delta is the one ``tiers.pack_q8_region`` makes from the host
    codes.  At 256 blocks a delta frame of 252 changed blocks is still the
    smaller one (13 + 252 * 264 bytes against 9 + 256 * 260), and one of
    253 is not."""
    from repro_torch.core.snapshot import _delta_is_smaller
    from repro_torch.core.tiers import DeltaState, pack_q8_region
    from repro_torch.kernels.ckpt_codec import quantize, quantize_delta

    nb = 256
    x0 = np.random.default_rng(4).standard_normal(nb * 256) \
        .astype(np.float32)
    x1 = x0.copy()
    x1.reshape(nb, 256)[:changed, 0] += 1.0
    q0, s0 = quantize(torch.from_numpy(x0))
    prev = DeltaState(n=x0.size, codes=q0.numpy(), scales=s0.numpy())
    d, s, q = quantize_delta(torch.from_numpy(x1), q0)
    _, _, frame = pack_q8_region({0: (x1.size, q.numpy(), s.numpy())},
                                 {0: prev})
    assert frame == ("delta" if changed <= 252 else "key")
    assert _delta_is_smaller(d, s, prev) == (frame == "delta")
