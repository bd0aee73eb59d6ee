"""``repro_torch.roofline`` against ``repro.roofline``: the analytic memory
model ``analytic_bytes_for`` and the useful-FLOPs count ``model_flops_for``
return exactly the reference's for all 10 archs x 4 shapes x the meshes
1x1, 2x2, 16x16 and 2x16x16, at 1- and 2-byte KV and 1 and 4 microbatches;
``RooflineTerms`` on a hand-computed case with the H100's constants; and
``meta_counts`` reading a dry mesh's transports."""
import pytest

pytest.importorskip("torch")

import torch  # noqa: E402

from repro import roofline as ref_RL  # noqa: E402
from repro.configs import ARCHS, SHAPES  # noqa: E402
from repro_torch import roofline as RL  # noqa: E402
from repro_torch.configs import ARCHS as T_ARCHS  # noqa: E402
from repro_torch.configs import SHAPES as T_SHAPES  # noqa: E402

MESHES = {"1x1": {"data": 1, "model": 1}, "2x2": {"data": 2, "model": 2},
          "16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_analytic_bytes_and_model_flops_equal_reference(name, mesh):
    mesh_shape = MESHES[mesh]
    chips = 1
    for v in mesh_shape.values():
        chips *= v
    for shape_name in sorted(SHAPES):
        cfg, shape = ARCHS[name], SHAPES[shape_name]
        t_cfg, t_shape = T_ARCHS[name], T_SHAPES[shape_name]
        for kv_bytes in (1.0, 2.0):
            for n_micro in (1, 4):
                want = ref_RL.analytic_bytes_for(cfg, shape, mesh_shape,
                                                 n_micro=n_micro,
                                                 kv_bytes=kv_bytes)
                got = RL.analytic_bytes_for(t_cfg, t_shape, mesh_shape,
                                            n_micro=n_micro, kv_bytes=kv_bytes)
                assert got == want, (shape_name, kv_bytes, n_micro)
        assert RL.model_flops_for(t_cfg, t_shape, chips) == \
            ref_RL.model_flops_for(cfg, shape, chips), shape_name


def test_roofline_terms_carry_the_h100_constants():
    """1e15 FLOPs, 6.7e12 HBM bytes and 9e11 collective bytes: 1.0111 s of
    compute at 989 TFLOP/s, 2 s of memory at 3.35 TB/s, 2 s of collective
    at 450 GB/s (memory wins the tie by order); 5e14 useful FLOPs."""
    assert (RL.PEAK_FLOPS, RL.HBM_BW, RL.LINK_BW) == (989e12, 3.35e12, 450e9)
    t = RL.RooflineTerms(flops=1e15, bytes_hbm=6.7e12, bytes_coll=9e11,
                         model_flops=5e14)
    assert t.t_compute == pytest.approx(1e15 / 989e12, rel=1e-12)
    assert t.t_memory == pytest.approx(2.0, rel=1e-12)
    assert t.t_collective == pytest.approx(2.0, rel=1e-12)
    assert t.bottleneck == "memory"
    assert t.bound_time == pytest.approx(2.0, rel=1e-12)
    assert t.useful_ratio == 0.5
    assert t.roofline_fraction == pytest.approx((5e14 / 989e12) / 2.0, rel=1e-12)
    ref = ref_RL.RooflineTerms(1.0, 1.0, 1.0, 1.0)
    assert list(t.to_dict()) == list(ref.to_dict())
    assert RL.RooflineTerms(0.0, 0.0, 0.0).roofline_fraction == 0.0


def test_meta_counts_reads_the_dry_mesh_by_kind():
    from repro_torch.launch.mesh import Mesh
    mesh = Mesh((2, 4), ("data", "model"), rank=5, dry=True)
    x = torch.empty((3, 8), dtype=torch.bfloat16, device="meta")
    mesh.all_reduce(x, "model")
    mesh.all_gather(x, ("data", "model"), dim=0)
    mesh.ring_shift(x, "data")
    counts = RL.meta_counts(123.0, mesh)
    assert counts["flops"] == 123.0
    assert counts["all-reduce"] == 48 and counts["all-gather"] == 8 * 48
    assert counts["collective-permute"] == 48
    assert counts["reduce-scatter"] == counts["all-to-all"] == 0
    assert counts["total_collective"] == 10 * 48
    assert counts["calls"]["all-gather"] == 1
    assert set(ref_RL._COLLECTIVES) <= set(counts)
