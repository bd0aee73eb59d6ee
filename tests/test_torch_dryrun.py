"""The meta-device dry run (``repro_torch.launch.dryrun``) against the
reference's compiled one (``repro.launch.dryrun``):

* the dry mesh's transports give the shapes, dtypes, calls and output
  bytes of two real gloo ranks';
* rank 0's blocks of every applicable decode and prefill cell's args on
  16x16 and 2x16x16, and of granite's and mamba2's train cells on 16x16,
  have the shapes of the reference's ``build_cell`` args under
  ``NamedSharding.shard_shape`` (no compile; 512 fake devices in a
  subprocess);
* a reduced granite-3-8b train cell and decode cell on 2x2: the FLOPs and
  the collective bytes per kind of rank 0's meta run against the
  reference's compiled cell (``analyze_hlo``), within the factors below;
* ``run_cell``'s record carries the reference's keys, its skip record the
  reference's reason, and the CLI writes ``ok`` records.

Factors of the 2x2 check.  FLOPs within 1.25x: both count matrix products
only (``FlopCounterMode``; the HLO's dots, loop-aware), but the port's
attention is its plain version, whose square is full where the
reference's blockwise attention skips masked blocks, and the two programs
remat and chunk the loss at their own granularity.  Collective bytes:
the reference's are XLA-CPU's, which upcasts bf16 collectives to f32
(``analyze_hlo`` halves them in ``total_collective``; per kind they are
scaled here by the same ratio).  The totals must agree within 2x and each
kind the port moves within 4x: the port's reduce-scatters are all-reduces
and a slice (a kind's bytes move from ``reduce-scatter`` to
``all-reduce``, so the two are summed), ZeRO-1 gathers f32 masters, the
sharded argmax gathers (value, index) pairs where GSPMD gathers what it
chooses, and GSPMD adds all-to-alls and permutes to reshard, which the
port never needs."""
import json

import pytest

pytest.importorskip("torch")

import torch  # noqa: E402

import torch_launch_parity as lp  # noqa: E402
from repro_torch.bridge import tree_flatten  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES, get_arch, reduced, shape_applicable  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.launch import dryrun, specs  # noqa: E402
from repro_torch.launch.mesh import Mesh, make_production_mesh  # noqa: E402

FLOPS_FACTOR, TOTAL_FACTOR, KIND_FACTOR = 1.25, 2.0, 4.0
LAYOUTS = {"16x16": ((16, 16), ("data", "model")),
           "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
SMALL = {"train": ShapeConfig("train_small", seq_len=64, global_batch=8, kind="train"),
         "decode": ShapeConfig("decode_small", seq_len=256, global_batch=8,
                               kind="decode")}
SMALL_ARCH = "granite-3-8b"


def cells():
    out = []
    for layout in LAYOUTS:
        for arch in sorted(ARCHS):
            for shape in ("decode_32k", "long_500k", "prefill_32k"):
                if shape_applicable(ARCHS[arch], SHAPES[shape])[0]:
                    out.append((layout, arch, shape))
    out += [("16x16", "granite-3-8b", "train_4k"), ("16x16", "mamba2-2.7b", "train_4k")]
    return out


REFERENCE = """
from jax.sharding import NamedSharding
from repro import roofline as RL
from repro.configs import ARCHS, reduced
from repro.configs.base import ShapeConfig
from repro.launch import specs
devs = np.array(jax.devices())
meshes = {"16x16": Mesh(devs[:256].reshape(16, 16), ("data", "model")),
          "2x16x16": Mesh(devs.reshape(2, 16, 16), ("pod", "data", "model"))}
out = {}
for layout, arch, shape in CELLS:
    cell = specs.build_cell(arch, shape, meshes[layout])
    leaves = jax.tree.leaves(cell.args)
    shards = jax.tree.leaves(cell.in_shardings,
                             is_leaf=lambda s: isinstance(s, NamedSharding))
    assert len(leaves) == len(shards)
    for i, (a, s) in enumerate(zip(leaves, shards)):
        out[f"shape/{layout}/{arch}/{shape}/{i}"] = np.asarray(
            s.shard_shape(a.shape), dtype=np.int64).reshape(-1)
mesh = Mesh(devs[:4].reshape(2, 2), ("data", "model"))
cfg = reduced(ARCHS[SMALL_ARCH])
for kind, (seq, batch) in SMALL.items():
    shape = ShapeConfig(kind, seq_len=seq, global_batch=batch, kind=kind)
    build = specs.build_train_cell if kind == "train" else specs.build_decode_cell
    cell = build(cfg, shape, mesh)
    kw = {} if cell.out_shardings is None else {"out_shardings": cell.out_shardings}
    with mesh:
        compiled = jax.jit(cell.fn, in_shardings=cell.in_shardings,
                           donate_argnums=cell.donate, **kw).lower(*cell.args).compile()
    coll = RL.analyze_hlo(compiled.as_text())
    for k, v in coll.items():
        out[f"small/{kind}/{k}"] = np.asarray(float(v))
np.savez(OUT, **out)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("dryrun")
    small = {k: (s.seq_len, s.global_batch) for k, s in SMALL.items()}
    body = (f"CELLS = {cells()!r}\nSMALL = {small!r}\n"
            f"SMALL_ARCH = {SMALL_ARCH!r}\n" + REFERENCE)
    return lp.run_reference(body, 512, workdir, timeout=300)


def test_dry_transports_match_real_ranks(tmp_path):
    lp.spawn_ranks(lp.transport_rank, 2, str(tmp_path))
    for rank in (0, 1):
        real = json.loads((tmp_path / f"rank{rank}.json").read_text())
        mesh = Mesh((1, 2), ("data", "model"), rank=rank, dry=True)
        shapes, stats = lp.transport_script(mesh, "meta")
        assert [[list(s), d] for s, d in shapes] == real["shapes"]
        assert stats == real["stats"]


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_rank0_args_have_the_reference_shard_shapes(reference, layout):
    shape, axes = LAYOUTS[layout]
    mesh = Mesh(shape, axes, rank=0, dry=True)
    checked = 0
    for lay, arch, shape_name in cells():
        if lay != layout:
            continue
        cell = specs.build_cell(arch, shape_name, mesh)
        leaves = tree_flatten(dryrun.cut_args(cell.args, cell.in_shardings, mesh))[0]
        key = f"shape/{layout}/{arch}/{shape_name}"
        want = [tuple(int(d) for d in reference[f"{key}/{i}"])
                for i in range(len(leaves))]
        assert f"{key}/{len(leaves)}" not in reference, key
        assert [tuple(a.shape) for a in leaves] == want, key
        assert all(a.device.type == "meta" for a in leaves)
        checked += 1
    assert checked >= 20


def _small_cell(kind, mesh):
    cfg = reduced(get_arch(SMALL_ARCH))
    build = specs.build_train_cell if kind == "train" else specs.build_decode_cell
    return build(cfg, SMALL[kind], mesh)


@pytest.mark.parametrize("kind", sorted(SMALL))
def test_reduced_cell_flops_and_collectives_near_compiled_reference(reference, kind):
    mesh = Mesh((2, 2), ("data", "model"), rank=0, dry=True)
    rec = dryrun.analyze_cell(_small_cell(kind, mesh), mesh)
    ref = {k.split("/")[-1]: float(v) for k, v in reference.items()
           if k.startswith(f"small/{kind}/")}
    got = rec["collectives"]
    ratio = got["flops"] / ref["flops"]
    assert 1 / FLOPS_FACTOR <= ratio <= FLOPS_FACTOR, (got["flops"], ref["flops"])
    assert rec["roofline"]["flops_per_chip"] == got["flops"]
    ratio = got["total_collective"] / ref["total_collective"]
    assert 1 / TOTAL_FACTOR <= ratio <= TOTAL_FACTOR, (got, ref)
    scale = ref["total_collective"] / ref["total_collective_raw"]
    pairs = {"all-gather": (got["all-gather"], ref["all-gather"]),
             "all-reduce": (got["all-reduce"] + got["reduce-scatter"],
                            ref["all-reduce"] + ref["reduce-scatter"])}
    for kind_name, (mine, theirs) in pairs.items():
        if mine or theirs:
            ratio = mine / (theirs * scale)
            assert 1 / KIND_FACTOR <= ratio <= KIND_FACTOR, (kind_name, got, ref)
    assert got["reduce-scatter"] == got["all-to-all"] == 0


def test_record_has_the_reference_keys(tmp_path):
    """The reference's record (``repro/launch/dryrun.py:88-114``) with
    ``lower_s``/``compile_s`` as ``trace_s``, ``fits_hbm_16g`` as
    ``fits_hbm_80g``, and ``temp_bytes``/``code_bytes`` null."""
    mesh = make_production_mesh()
    rec = dryrun.run_cell("granite-3-8b", "decode_32k", "single", mesh,
                          str(tmp_path), force=True)
    assert rec["status"] == "ok", rec.get("trace")
    want = {"arch", "shape", "mesh", "kv_dtype", "status", "n_chips",
            "memory", "collectives", "cost_analysis_raw", "roofline", "meta"}
    renamed = {"trace_s", "fits_hbm_80g", "limits"}
    assert set(rec) == want | renamed
    mem = rec["memory"]
    assert {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
            "code_bytes", "peak_per_device"} <= set(mem)
    assert mem["temp_bytes"] is None and mem["code_bytes"] is None
    assert mem["peak_per_device"] == (mem["argument_bytes"] + mem["output_bytes"]
                                      - mem["alias_bytes"])
    assert 0 < mem["alias_bytes"] <= mem["output_bytes"]
    assert {"flops", "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
            "collective-permute", "total_collective"} <= set(rec["collectives"])
    assert rec["n_chips"] == 256 and rec["fits_hbm_80g"]
    assert "full square" in rec["limits"] and "lower" in rec["limits"]
    assert json.loads((tmp_path / "single" / "granite-3-8b__decode_32k.json")
                      .read_text()) == rec
    # cached unless forced
    assert dryrun.run_cell("granite-3-8b", "decode_32k", "single", mesh,
                           str(tmp_path)) == rec


def test_skip_record_names_the_reference_reason(tmp_path):
    from repro.configs import ARCHS as REF_ARCHS
    from repro.configs import SHAPES as REF_SHAPES
    from repro.configs import shape_applicable as ref_applicable
    rec = dryrun.run_cell("granite-3-8b", "long_500k", "single",
                          make_production_mesh(), str(tmp_path))
    ok, why = ref_applicable(REF_ARCHS["granite-3-8b"], REF_SHAPES["long_500k"])
    assert not ok
    assert rec == {"arch": "granite-3-8b", "shape": "long_500k", "mesh": "single",
                   "status": "skipped", "reason": why}


def test_cli_writes_ok_records(tmp_path, capsys):
    for shape in ("decode_32k", "prefill_32k"):
        assert dryrun.main(["--arch", "granite-3-8b", "--shape", shape,
                            "--mesh", "single", "--out", str(tmp_path)]) == 0
        rec = json.loads((tmp_path / "single" / f"granite-3-8b__{shape}.json")
                         .read_text())
        assert rec["status"] == "ok"
        assert rec["roofline"]["flops_per_chip"] > 0
    assert "done: 1 ok, 0 skipped, 0 errors" in capsys.readouterr().out
    assert dryrun._artifact_dir().endswith("build/dryrun")


def test_the_dry_run_allocates_nothing_and_needs_a_dry_mesh():
    mesh = Mesh((2, 2), ("data", "model"), rank=0, dry=True)
    cell = _small_cell("decode", mesh)
    args = dryrun.cut_args(cell.args, cell.in_shardings, mesh)
    assert all(a.device.type == "meta" for a in tree_flatten(args)[0]
               if isinstance(a, torch.Tensor))
    with pytest.raises(ValueError, match="dry"):
        dryrun.analyze_cell(cell, Mesh((2, 2), ("data", "model")))
    with pytest.raises(ValueError, match="one rank"):
        Mesh((2, 2), ("data", "model"), dry=True)
