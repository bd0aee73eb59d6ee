"""``ValetCheckpointer`` and the elastic plans of the port: the reference's
checkpointer and elastic tests (``tests/test_train.py``) on the port, the
on-disk layout against the reference checkpointer's, a bf16 round trip bit
for bit, an ``AdamWState`` round trip, and resuming training from a
restored snapshot."""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.train import ValetCheckpointer as RefCheckpointer  # noqa: E402
from repro_torch import bridge, optim  # noqa: E402
from repro_torch.configs import ARCHS, reduced  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.train import (ClusterSpec, TrainConfig,  # noqa: E402
                               ValetCheckpointer, degraded_mesh_shape,
                               make_recovery_plan, make_train_step)


def test_checkpointer_async_restore(tmp_path):
    ckpt = ValetCheckpointer(str(tmp_path), replicas=2, keep=2)
    tree = {"w": np.arange(10, dtype=np.float32),
            "b": {"x": np.ones((3, 3), np.float32)}}
    dt = ckpt.save(1, tree)
    assert dt < 1.0                       # staging is the only critical path
    tree["w"] = tree["w"] + 1
    ckpt.save(2, tree)
    ckpt.wait()
    step, restored = ckpt.restore()
    assert step == 2
    np.testing.assert_array_equal(restored["w"], tree["w"])
    ckpt.close()


def test_checkpointer_replica_failover(tmp_path):
    ckpt = ValetCheckpointer(str(tmp_path), replicas=2)
    tree = {"w": np.arange(6, dtype=np.float32)}
    ckpt.save(3, tree)
    ckpt.wait()
    # corrupt replica 0 (primary): restore must fall back to replica 1
    r0 = os.path.join(str(tmp_path), "replica0", "step_00000003",
                      "arrays.npz")
    with open(r0, "wb") as f:
        f.write(b"garbage")
    step, restored = ckpt.restore()
    assert step == 3
    np.testing.assert_array_equal(restored["w"], tree["w"])
    ckpt.close()


def test_checkpointer_skips_stale_snapshots(tmp_path):
    """Update-flag semantics: a newer staged snapshot supersedes older."""
    ckpt = ValetCheckpointer(str(tmp_path), replicas=1)
    for s in range(6):
        ckpt.save(s, {"w": np.full(4, s, np.float32)})
    ckpt.wait()
    step, restored = ckpt.restore()
    assert step == 5
    np.testing.assert_array_equal(restored["w"], np.full(4, 5, np.float32))
    ckpt.close()


def test_elastic_degraded_mesh():
    spec = ClusterSpec(n_pods=2, data_parallel=16, model_parallel=16)
    # lose 20 devices: TP stays 16, DP shrinks
    d = degraded_mesh_shape(spec, spec.n_devices - 20)
    assert d is not None and d.model_parallel == 16
    assert d.n_devices <= spec.n_devices - 20 + 16
    # catastrophic loss
    assert degraded_mesh_shape(spec, 7) is None


def test_recovery_plan():
    spec = ClusterSpec(n_pods=1, data_parallel=4, model_parallel=4)
    plan = make_recovery_plan(spec, alive_devices=list(range(9)),
                              restore_step=123)
    assert plan is not None
    assert plan["restore_step"] == 123
    assert len(plan["devices_used"]) == plan["mesh"].n_devices
    assert all(step == 123 for _, step in plan["data_shards"])


def test_layout_and_gc_match_the_reference(tmp_path):
    """The same snapshots through both checkpointers leave the same
    directories, manifests and arrays (keep=2 collects the oldest)."""
    trees = [{"b": np.full((2, 3), s, np.float32),
              "a": [np.arange(4, dtype=np.int32) + s]} for s in range(3)]
    out = {}
    for name, cls in (("ref", RefCheckpointer), ("port", ValetCheckpointer)):
        d = tmp_path / name
        ckpt = cls(str(d), replicas=2, keep=2)
        for s, t in enumerate(trees):
            ckpt.save(s, t)
            ckpt.wait()
        ckpt.close()
        out[name] = {}
        for r in sorted(os.listdir(d)):
            for snap in sorted(os.listdir(d / r)):
                with open(d / r / snap / "manifest.json") as f:
                    manifest = json.load(f)
                with np.load(d / r / snap / "arrays.npz") as z:
                    arrays = {k: z[k] for k in z.files}
                out[name][(r, snap)] = (manifest, arrays)
    assert out["ref"].keys() == out["port"].keys()
    assert [k[1] for k in out["port"]] == ["step_00000001", "step_00000002"] * 2
    for key, (manifest, arrays) in out["ref"].items():
        pm, pa = out["port"][key]
        assert pm == manifest
        assert pa.keys() == arrays.keys()
        for k in arrays:
            np.testing.assert_array_equal(pa[k], arrays[k])
            assert pa[k].dtype == arrays[k].dtype


def test_bf16_round_trip_bits(tmp_path):
    """bf16 leaves come back bit for bit (inf, -0, nan, a subnormal)
    through ``restore_tensors``, and widened exactly to float32 through
    ``restore``; the staged copy does not alias the caller's tensor."""
    gen = torch.Generator().manual_seed(0)
    w = torch.randn((5, 7), generator=gen).to(torch.bfloat16)
    w[0, :4] = torch.tensor([float("inf"), -0.0, float("nan"), 1e-40])
    want = w.clone()
    tree = {"w": w, "f": torch.randn((3,), generator=gen),
            "i": torch.arange(4, dtype=torch.int32)}
    ckpt = ValetCheckpointer(str(tmp_path), replicas=1)
    ckpt.save(1, tree)
    w.fill_(0)                            # after save() returns: not staged
    ckpt.wait()
    with open(tmp_path / "replica0" / "step_00000001" / "manifest.json") as f:
        assert json.load(f)["dtypes"] == ["float32", "int32", "bfloat16"]
    step, got = ckpt.restore_tensors("cpu")
    assert step == 1 and got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"].view(torch.int16), want.view(torch.int16))
    assert torch.equal(got["f"], tree["f"]) and torch.equal(got["i"], tree["i"])
    step, arrays = ckpt.restore()
    assert arrays["w"].dtype == np.float32
    np.testing.assert_array_equal(arrays["w"], want.float().numpy())
    ckpt.close()


def test_adamw_state_round_trip(tmp_path):
    """A (params, AdamWState) snapshot restores into the same NamedTuple,
    the int32 step included; a fresh checkpointer takes the structure from
    ``tree_like``."""
    params = {"w": torch.randn((4, 3)), "n": torch.randn((3,)).to(torch.bfloat16)}
    state = optim.init(params)._replace(step=torch.tensor(9, dtype=torch.int32))
    ckpt = ValetCheckpointer(str(tmp_path), replicas=2)
    ckpt.save(9, (params, state))
    ckpt.close()
    fresh = ValetCheckpointer(str(tmp_path), replicas=2)
    step, flat = fresh.restore_tensors("cpu")
    assert step == 9 and isinstance(flat, list) and len(flat) == 7
    step, (p2, s2) = fresh.restore_tensors("cpu", tree_like=(params, state))
    assert isinstance(s2, optim.AdamWState)
    assert s2.step.dtype == torch.int32 and int(s2.step) == 9
    for a, b in zip(bridge.tree_flatten((params, state))[0],
                    bridge.tree_flatten((p2, s2))[0]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    fresh.close()


def test_resume_from_a_restored_snapshot_is_bit_exact(tmp_path):
    """Two steps straight through, against one step, a save, a restore into
    a fresh checkpointer, and the second step from the restored state:
    equal bit for bit (the CPU step is deterministic)."""
    cfg = reduced(ARCHS["granite-3-8b"])
    params = T.init_params(cfg, generator=torch.Generator().manual_seed(0),
                           device="cpu")
    ctx = T.ParallelCtx(remat=True, q_block=8, kv_block=8, loss_chunk=8)
    step = make_train_step(cfg, ctx, TrainConfig(
        microbatches=2, compute_dtype=torch.bfloat16,
        adamw=optim.AdamWConfig(lr=1e-3, warmup_steps=0)))
    rng = np.random.default_rng(0)
    batches = [torch.from_numpy(rng.integers(0, cfg.vocab, (2, 2, 16)))
               for _ in range(4)]
    p1, s1, _ = step(params, optim.init(params), batches[0], batches[1])
    p2, s2, m2 = step(p1, s1, batches[2], batches[3])
    ckpt = ValetCheckpointer(str(tmp_path), replicas=2)
    ckpt.save(1, {"params": p1, "opt": s1})
    ckpt.close()
    _, got = ValetCheckpointer(str(tmp_path), replicas=2).restore_tensors(
        "cpu", tree_like={"params": p1, "opt": s1})
    r2, rs2, rm2 = step(got["params"], got["opt"], batches[2], batches[3])
    assert torch.equal(rm2["loss"], m2["loss"])
    for a, b in zip(bridge.tree_flatten((p2, s2))[0],
                    bridge.tree_flatten((r2, rs2))[0]):
        assert torch.equal(a, b)
